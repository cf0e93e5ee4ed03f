"""Async trainer->engine update ingestion (port of
``repro/serving/update_pipe.py``; §3/§6).

The serving engine decodes, dequantizes and requantizes every update frame
off the request path:

* :class:`UpdatePipe` owns the transfer
  :class:`~repro_torch.checkpoint.transfer.Receiver` and decodes every frame
  into a **standby params tree** while scorers keep reading the active one
  (double buffering by immutability: the retiring generation lives exactly
  as long as the last scorer snapshot holding it); only the final publish —
  the engine's atomic ``(params, generation)`` swap — touches the engine
  lock, and that is a pointer exchange, not weight work.
* :meth:`submit` enqueues a frame for the background ingest thread and
  returns immediately; :meth:`ingest` is the synchronous path the engine's
  ``apply_update`` wraps. Both funnel through one ingest lock, so frames
  apply in order no matter how they arrive.

On the card the decode's device work (the K9 dequantization, the
requantized tables' scatters) runs on the pipe's own CUDA stream, never on
the scorers' (the default stream); the stream is synchronized before the
publish, and the published tensors are marked as used on the default
stream, so the allocator does not hand their memory to the pipe's stream
while a scorer's kernels may still read it. Cache prewarm runs on the
scorers' stream, after that synchronization.

Invariants (the async-ingest contract):

1. Receiver state is only ever touched under ``_ingest_lock`` — frames are
   strictly ordered, mixing submit/ingest cannot interleave byte-patching.
2. A published generation is always a fully materialized tree, complete on
   the device; scorers snapshot ``(params, generation)`` once per batch and
   never observe a half-decoded update.
3. The request path never blocks on ingest: scoring takes only the engine
   lock, which ingest holds just for the pointer swap.
"""
from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import layout, transfer
from repro_torch.core import quantization as Q

# frames queued for the background thread before ``submit(block=True)`` waits
MAX_PENDING = 8
# sleep between prewarm chunks on the background thread (cooperative
# throttling; none while a flush() waits)
PREWARM_PAUSE_S = 0.002


def _dtype_tree(tree):
    """The nested-dict structure of ``tree`` with each leaf's dtype."""
    if isinstance(tree, dict):
        return {k: _dtype_tree(v) for k, v in tree.items()}
    return layout.leaf_dtype(tree)


def _merge_row_ranges(rr):
    """Sort ``(start, stop)`` ranges and coalesce overlapping/adjacent ones."""
    rr = sorted(rr)
    merged = [rr[0]]
    for s, e in rr[1:]:
        if s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


@dataclass
class UpdatePipeStats:
    submitted: int = 0
    published: int = 0
    rejected: int = 0          # queue-full drops (backpressure)
    decode_seconds: float = 0.0  # off-request-path work: decode+materialize
    bytes_ingested: int = 0
    idle_priority: bool = False  # ingest thread demoted below scorers
    contexts_refreshed: int = 0  # cache partials re-warmed post-publish
    # quantize-on-ingest (engines with quantized=True): embedding rows /
    # LR blocks (re)quantized to int8 across all frames, and the CPU spent
    # doing it. Steady-state delta frames requantize only their touched
    # rows/blocks, so both counters grow with frame size, not model size.
    rows_requantized: int = 0
    blocks_requantized: int = 0
    quantize_seconds: float = 0.0
    # the decode's stages, device work included (the pipe's stream is
    # synchronized after each): applying the frame bytes, and materializing
    # (uploading and dequantizing the codes)
    frame_seconds: float = 0.0
    dequant_seconds: float = 0.0
    # frame-integrity NACK state: frames rejected by the transfer
    # layer's typed FrameError taxonomy (corrupt bytes, broken version
    # chain), and the last such error — the receiver's NACK, which the
    # fleet answers with a ShardedSender resync frame.
    frames_rejected: int = 0
    last_frame_error: Optional[str] = None
    # unexpected (non-FrameError) ingest failures: the background thread
    # survives them, but they must stay observable — a burst of failed
    # frames that only reached the log would look like a healthy-but-stale
    # pipe to the router's health prober
    frames_failed: int = 0
    last_ingest_error: Optional[str] = None


class UpdatePipe:
    """Background ingestion of trainer update frames into a serving engine.

    ``engine`` must expose ``device`` and ``_publish(params, version,
    nbytes) -> generation`` (the atomic swap). ``manifest``/``like_params``
    are the decode defaults; per-call overrides win. The pipe starts its
    daemon thread lazily on the first :meth:`submit`; purely synchronous use
    (the engine's ``apply_update``) never spawns a thread.
    """

    def __init__(self, engine, *, manifest=None, like_params=None):
        self._engine = engine  # guarded-by: _ingest_lock
        self._receiver = transfer.Receiver(  # guarded-by(calls): _ingest_lock
            device=engine.device)
        self._manifest = None  # guarded-by: _ingest_lock
        self._like = None      # guarded-by: _ingest_lock
        self._configure_locked(manifest, like_params)  # still private here
        self._q: "queue.Queue" = queue.Queue(maxsize=MAX_PENDING)
        # the decode's own CUDA stream (None for a CPU engine)
        self._stream = (torch.cuda.Stream(device=engine.device)
                        if engine.device.type == "cuda" else None)
        self._ingest_lock = threading.Lock()
        self._pending = 0  # submitted, unpublished; guarded-by: _pending_cv
        self._pending_cv = threading.Condition()
        # flush() waiters currently blocked on the drain (under _pending_cv):
        # while > 0 the ingest thread runs *un*throttled at normal priority —
        # a flush is an explicit synchronization point, and on a saturated
        # box a SCHED_IDLE + throttled ingest thread can otherwise be starved
        # past any flush timeout by hot scorer threads (1-core worst case)
        self._hurry = 0  # guarded-by: _pending_cv
        self._ingest_tid: Optional[int] = None
        self._thread: Optional[threading.Thread] = None  # guarded-by: _thread_lock
        self._thread_lock = threading.Lock()
        self._closed = False  # guarded-by: _pending_cv
        self._dead = False  # kill(): frames dropped; guarded-by: _pending_cv
        # fault-injection hook (serving.faults.FaultPlan): every ingest calls
        # its on_ingest first; None (the default) costs nothing
        self.faults = None
        # quantize-on-ingest: the last qparams THIS pipe published (the
        # engine's current params in the normal flow — no extra copy); the
        # incremental-requantize base tied to the receiver's wire state
        self._last_qparams = None  # guarded-by: _ingest_lock
        self.stats = UpdatePipeStats()

    # -- configuration ------------------------------------------------------
    @property
    def version(self) -> int:
        """Trainer round stamp of the last applied frame."""
        return self._receiver.version

    def configure(self, manifest=None, like_params=None) -> None:
        """Set/refresh the decode defaults (layout manifest + pytree shape).

        Only the tree structure and leaf dtypes of ``like_params`` are kept
        (shapes come from the manifest): retaining the live tensors would pin
        the trainer's device memory.

        Serialized behind ``_ingest_lock`` so a reconfigure can never land
        mid-decode on the background ingest thread.
        """
        with self._ingest_lock:
            self._configure_locked(manifest, like_params)

    def _configure_locked(self, manifest=None, like_params=None) -> None:  # requires-lock: _ingest_lock
        if manifest is not None:
            self._manifest = manifest
        if like_params is not None:
            self._like = _dtype_tree(like_params)

    # -- synchronous path (engine.apply_update) -----------------------------
    def ingest(self, update: bytes, manifest=None, like_params=None):
        """Decode one frame into a standby params pytree and publish it.
        Blocks the *caller*; scorers only ever wait for the final pointer
        swap."""
        if (self._thread is not None
                and threading.current_thread() is not self._thread):
            # frames must apply in submission order: a synchronous ingest
            # overtaking frames still queued for the background thread would
            # patch/XOR against the wrong base bytes. flush() alone leaves a
            # window — a frame submitted between flush returning and the
            # lock acquisition would still be overtaken — so loop
            # flush-then-verify: only proceed when the lock is held AND
            # nothing is pending (checked under _pending_cv, which submit
            # increments before enqueueing).
            while True:
                if not self.flush() and self._dead:
                    raise RuntimeError("update pipe was killed")
                self._ingest_lock.acquire()
                with self._pending_cv:
                    drained = self._pending == 0
                if drained:
                    break
                self._ingest_lock.release()
            try:
                return self._ingest_locked(update, manifest, like_params)
            finally:
                self._ingest_lock.release()
        with self._ingest_lock:
            return self._ingest_locked(update, manifest, like_params)

    def _ingest_locked(self, update: bytes, manifest=None, like_params=None):  # requires-lock: _ingest_lock
        """Decode + publish one frame; caller holds ``_ingest_lock``."""
        t0 = time.perf_counter()
        if self._dead:
            raise RuntimeError("update pipe was killed")
        if manifest is not None or like_params is not None:
            self._configure_locked(manifest, like_params)
        on_ingest_thread = (self._thread is not None
                            and threading.current_thread() is self._thread)
        if self.faults is not None:
            self.faults.on_ingest(len(update))
        with self._on_stream():
            try:
                self._receiver.apply_update(update)
            except transfer.FrameError as e:
                # typed wire fault: count it, remember the NACK, and leave
                # the receiver state untouched (apply_update guarantees no
                # partial mutation) so a resync frame lands cleanly afterwards
                self.stats.frames_rejected += 1
                self.stats.last_frame_error = f"{type(e).__name__}: {e}"
                raise
            t1 = time.perf_counter()
            self.stats.frame_seconds += t1 - t0
            params = self._receiver.materialize(manifest=self._manifest,
                                                like=self._like)
            self._settle()
            tq = time.perf_counter()
            self.stats.dequant_seconds += tq - t1
            if getattr(self._engine, "quantized", False):
                # quantize-on-ingest (§6 serving): the standby slot holds
                # int8 rows + per-row grids, not f32. A delta frame's touched
                # element ranges map to embedding rows / LR blocks, and only
                # those requantize (per-row and per-block grids are
                # independent, so untouched ones stay byte-identical);
                # full/patch frames requantize everything. ``prev`` is the
                # pipe's OWN last publish, not ``engine.params``: untouched
                # rows must copy codes quantized from the receiver's previous
                # wire state — an ``install_params`` that diverged from the
                # wire stream must not leak rows into this frame.
                qstats: dict = {}
                params = Q.quantize_params_rows(
                    params, prev=self._last_qparams,
                    touched_rows=self._touched_leaf_rows(), stats=qstats)
                self._settle()
                self._last_qparams = params
                self.stats.rows_requantized += qstats.get("rows_requantized", 0)
                self.stats.blocks_requantized += qstats.get("blocks_requantized", 0)
                self.stats.quantize_seconds += time.perf_counter() - tq
        self._share_with_scorers(params)
        self.stats.decode_seconds += time.perf_counter() - t0
        self.stats.bytes_ingested += len(update)
        if on_ingest_thread and self._q.empty():
            # pre-warm cached context partials against the standby params
            # so the swap flips weights AND a warm cache in one step;
            # skipped when more frames are queued (only the last matters);
            # throttled unless a flush() waits (the hurry contract)
            prewarm = getattr(self._engine, "prewarm_contexts", None)
            if prewarm is not None:
                pause = 0.0 if self._hurried() else PREWARM_PAUSE_S
                self.stats.contexts_refreshed += prewarm(params, pause_s=pause)
        gen = self._engine._publish(params, self._receiver.version,
                                    len(update))
        self.stats.published += 1
        return gen

    def _on_stream(self):
        """Context in which the decode's device work runs: the pipe's own
        stream on the card."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _settle(self) -> None:
        """Wait for the decode's device work (not the scorers')."""
        if self._stream is not None:
            self._stream.synchronize()

    def _share_with_scorers(self, params) -> None:
        """Mark every tensor of a standby tree as used on the default stream,
        where scorers read it: freeing it then waits for their kernels
        before the allocator reuses its memory on the pipe's stream."""
        if self._stream is None:
            return
        scorers = torch.cuda.default_stream(self._stream.device)
        for _, leaf in layout.leaves(params):
            if isinstance(leaf, torch.Tensor):
                leaf.record_stream(scorers)

    def _touched_leaf_rows(self):
        """Map the receiver's last incremental-decode element ranges onto
        per-leaf row ranges: ``{"a/b": [(row_start, row_stop), ...]}`` over
        the manifest's concatenated-element layout. ``None`` means the decode
        was full (first frame, patch, regrid) — requantize everything.
        Widening element ranges to whole rows can make adjacent ranges
        overlap (two half-row ranges widen to the same row), so each leaf's
        ranges are merged before returning — otherwise the requantize would
        process rows twice and ``stats.rows_requantized`` would double-count.
        """
        ranges = self._receiver.last_touched_elems
        if ranges is None or self._manifest is None:
            return None
        out, pos = {}, 0
        for ent in self._manifest:
            n = int(np.prod(ent["shape"]) or 1)
            rows_total = int(ent["shape"][0]) if ent["shape"] else 1
            row_elems = max(n // max(rows_total, 1), 1)
            rr = []
            for s, m in ranges:
                lo, hi = max(s, pos), min(s + m, pos + n)
                if lo < hi:  # intersect, then widen to whole rows
                    rr.append(((lo - pos) // row_elems,
                               -(-(hi - pos) // row_elems)))
            if rr:
                out[ent["path"]] = _merge_row_ranges(rr)
            pos += n
        return out

    # -- asynchronous path --------------------------------------------------
    def submit(self, update: bytes, *, block: bool = False) -> bool:
        """Enqueue one frame for background ingestion; returns immediately.

        With ``block=False`` (default) a full queue drops the frame and
        counts it in ``stats.rejected`` — the next frame supersedes it anyway
        for full/patchless modes, and the trainer's Sender state assumes
        at-most-once shipping, so callers using patch/delta framing should
        pass ``block=True`` to apply backpressure instead of dropping.
        """
        with self._pending_cv:
            # closed-check and pending-increment are atomic under the cv:
            # a submit that merely *checked* closed first could enqueue its
            # frame behind close()'s None sentinel — silently dropped, with
            # _pending never decremented, hanging every later flush(). With
            # the increment inside the check, close()'s flush() waits for
            # this frame (or the submit sees _closed and raises).
            if self._closed:
                raise RuntimeError("update pipe is closed")
            self._pending += 1
        self._ensure_thread()
        self.stats.submitted += 1
        try:
            self._q.put(update, block=block)
            return True
        except queue.Full:
            with self._pending_cv:
                self._pending -= 1
                self._pending_cv.notify_all()
            self.stats.rejected += 1
            return False

    def flush(self, timeout: Optional[float] = 30.0) -> bool:
        """Wait until every submitted frame has been published (or dropped).

        Returns ``True`` when the pipe drained, ``False`` when the wait
        timed out or the pipe was :meth:`kill`-ed mid-wait — one boolean
        contract on every path, never raise-or-hang depending on how the
        frames arrived. Callers wanting the resulting generation read
        ``engine.generation`` after a ``True`` return.

        While any flusher waits, the background ingest thread is *hurried*:
        promoted back to normal scheduling and excused from pacing sleeps.
        The demotion/pacing exists to protect request-path p99 from decode
        bursts, but a flush is an explicit synchronization point — the caller
        has declared freshness more urgent than latency, and without the
        boost a saturated box (hot scorer threads, one core) can starve the
        SCHED_IDLE ingest thread past any finite timeout. The last flusher
        out re-demotes the thread."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._pending_cv:
            if self._pending == 0:
                return not self._dead
            if self._dead:
                return False
            self._hurry += 1
            promote = self._hurry == 1
        if promote:
            self._set_ingest_priority(idle=False)
        try:
            with self._pending_cv:
                while self._pending > 0 and not self._dead:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        return False
                    self._pending_cv.wait(remaining)
                return not self._dead
        finally:
            with self._pending_cv:
                self._hurry -= 1
                demote = self._hurry == 0
            if demote:
                self._set_ingest_priority(idle=True)

    def _hurried(self) -> bool:
        with self._pending_cv:
            return self._hurry > 0

    def kill(self) -> None:
        """Abort the pipe without draining: drop queued frames, wake every
        :meth:`flush` waiter (they return ``False``), and stop the ingest
        thread. Non-blocking and idempotent — the failover path
        (``ShardRouter.kill_shard``) must never deadlock behind a dead
        shard's pending frames. The in-flight frame (if any) finishes on its
        own; everything still queued is discarded."""
        with self._pending_cv:
            already = self._dead
            self._closed = True
            self._dead = True
            if not already:
                try:
                    while True:
                        if self._q.get_nowait() is not None:
                            self._pending -= 1
                except queue.Empty:
                    pass
            self._pending_cv.notify_all()
        if not already and self._thread is not None:
            self._q.put(None)  # queue just drained: cannot block

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain the queue and stop the ingest thread. ``_closed`` flips
        under ``_pending_cv`` *before* the sentinel is queued, pairing with
        the atomic closed-check in :meth:`submit`: every concurrent submit
        either lands ahead of the sentinel (drained by the flush loop) or
        observes the closed pipe and raises — no frame can be silently
        stranded behind the sentinel."""
        if self._thread is not None:
            # loop: a submit that won the race against _closed may still be
            # adding frames while the first flush drains
            while True:
                drained = self.flush(timeout)
                with self._pending_cv:
                    if not drained or self._pending == 0 or self._dead:
                        self._closed = True
                        break
            if not self._dead:
                self._q.put(None)
            self._thread.join(timeout)
        else:
            with self._pending_cv:
                self._closed = True

    # -- internals ----------------------------------------------------------
    def _ensure_thread(self) -> None:
        with self._thread_lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                name="update-pipe-ingest")
                self._thread.start()

    def _set_ingest_priority(self, *, idle: bool) -> None:
        """Demote (or restore) the ingest thread's OS scheduling, best-effort.

        ``idle=True`` parks it below every scoring thread — SCHED_IDLE where
        the kernel allows, else nice 19 (~1/20 weight); ``idle=False`` puts
        it back to normal for a hurried flush. Callable from any thread
        (Linux addresses threads by native id); a no-op before the thread
        has started or where the OS refuses the switch."""
        tid = self._ingest_tid
        if tid is None:
            return
        try:
            os.sched_setscheduler(
                tid, os.SCHED_IDLE if idle else os.SCHED_OTHER,
                os.sched_param(0))
            self.stats.idle_priority = idle
            return
        except (AttributeError, OSError, PermissionError):
            pass
        try:  # containers often reject sched classes; fall back to nice
            os.setpriority(os.PRIO_PROCESS, tid, 19 if idle else 0)
            self.stats.idle_priority = idle
        except (AttributeError, OSError, PermissionError):
            pass

    def _run(self) -> None:
        # Demote this thread below every scoring thread: on a busy box the
        # decode burst otherwise steals cores from concurrent scorers and
        # shows up as request-path p99 spikes — the exact stall async
        # ingestion exists to remove. SCHED_IDLE means ingest only consumes
        # cycles the request path leaves idle; freshness degrades gracefully
        # under saturation instead of latency — except under a waiting
        # flush(), which temporarily lifts the demotion. (Linux-only;
        # elsewhere the thread just runs at normal priority.)
        self._ingest_tid = threading.get_native_id()
        self._set_ingest_priority(idle=not self._hurried())
        while True:
            update = self._q.get()
            if update is None:
                return
            try:
                self.ingest(update)
            except transfer.FrameError:
                # corrupt/out-of-chain frame: already counted as a NACK in
                # stats (frames_rejected / last_frame_error); the thread
                # keeps serving later frames and awaits a resync
                logging.getLogger(__name__).warning(
                    "corrupt update frame rejected during background "
                    "ingest: %s", self.stats.last_frame_error)
            except Exception as e:  # a bad frame must not kill the thread
                self.stats.frames_failed += 1
                self.stats.last_ingest_error = f"{type(e).__name__}: {e}"
                logging.getLogger(__name__).exception(
                    "update frame rejected during background ingest")
            finally:
                with self._pending_cv:
                    self._pending -= 1
                    self._pending_cv.notify_all()
