"""Scatter-gather serving over hash-space-sharded engine shards (port of
``repro/serving/shard_router.py``; §2/§6).

:class:`ShardRouter` is the fleet's front end: it owns N
:class:`~repro_torch.serving.engine.InferenceEngine` shards, each holding a
**contiguous hash-space range** of the embedding rows and blocked-int8 LR
rows (:class:`repro_torch.launch.topology.ShardTopology`), splits every
request's candidate rows by owning shard, scores per-shard **partial
candidate terms** on the fleet's one :class:`ScoringPool`, and reduces them
into the final logit. Per-shard delta ingest arrives through per-shard
update pipes fed by :class:`repro_torch.checkpoint.transfer.ShardedSender`
frames. On one card a shard is a disjoint hash-space slice whose tables
live in device memory, and a replica is a second engine over
byte-identical tables.

Partial-sum reduction contract
------------------------------

The router's output is **bit-identical for every shard count N**
(including N = 1) at every generation, and within the quantization
tolerances of a single engine on the same tables:

* **Every pair term is computed in exactly one place, from fully assembled
  inputs.** Each *candidate entry* (one request row, candidate and
  candidate field) is owned by the shard holding its row. That shard's
  task gathers the row from its local table (kernel K1 on an int8 table,
  one launch per owning shard) and computes the entry's ctx-facing terms
  as a fixed-order chain of elementwise products and sums over ``k``
  (:func:`_dot_k`), never a library contraction, whose reduction order
  could depend on the shape. Entry lists pad to a power-of-two bucket,
  and an entry's terms do not depend on it.
* **Scatter in fixed shard order into disjoint positions** (a
  non-accumulating ``index_put_``): no position is written twice.
* **Cross-candidate pairs reduce at the router** from the scattered rows,
  with the same fixed-order chain; context pairs and LR sums come from the
  router's prefix cache over *assembled* rows (:class:`ShardedRows` /
  :class:`ShardedLR`, whose gathers run per owning shard into disjoint
  output rows, so they equal a gather over the whole table).

Streams: on the card each pool thread enqueues its shard's work on its own
CUDA stream, after waiting on an event the caller records behind the
inputs; the inputs are marked as used on that stream, the outputs as used
on the caller's stream, and every task ends by synchronizing its own event,
so a finished future means finished device work. A recycled gather buffer
is released with that event (:meth:`ScoringPool.release`).

Fault tolerance
---------------

``ShardRouter(replicas=M)`` runs M engines per slice, each with its own
receiver fed the *same* per-slice frame stream (``submit_updates`` tees
every frame), so siblings hold byte-identical tables and failover or
hedging never moves a score. Reads round-robin across a slice's healthy
replicas; a failed call fails over to an untried sibling; a call past the
hedge threshold is raced against a sibling, first response wins.
:class:`ReplicaHealth` is the per-replica breaker (healthy -> suspect ->
dead -> probing); a background prober revives dead replicas. Only when
every replica of a slice is dead do its rows score as zero contributions,
and the response is flagged (``ServeStats.last_degraded``,
``degraded_responses``; ``degraded`` latches). With
``score_batch(deadline_ms=)`` a slice that cannot answer in time is given
up as zero rows (``deadline_misses``). The request path never raises for
fleet health. Failure drills plug in through
:class:`repro_torch.serving.faults.FaultPlan`.
"""
from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import FIRST_COMPLETED, wait as _futures_wait
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.config import FFMConfig
from repro_torch.common.device import DeviceLike
from repro_torch.core import deepffm, ffm
from repro_torch.core import quantization as Q
from repro_torch.kernels.row_gather import ops as rg_ops
from repro_torch.launch.topology import ShardTopology
from repro_torch.serving.engine import (InferenceEngine, ScoringPool,
                                        _finish_candidates)
from repro_torch.serving.faults import FaultPlan


# ---------------------------------------------------------------------------
# Assembled-view tables (the router's virtual params)
# ---------------------------------------------------------------------------

def _host_index(idx) -> np.ndarray:
    return (idx.cpu().numpy() if isinstance(idx, torch.Tensor)
            else np.asarray(idx))


class _ShardedView:
    """Shared part of the two views: per-shard tables over contiguous
    ranges, gathered per owning shard in fixed shard order into disjoint
    output positions; dead shards (``parts[s] is None``) give zeros."""

    dtype = torch.float32
    row_shape: Tuple[int, ...] = ()

    def __init__(self, parts: Sequence, ranges: Sequence[Tuple[int, int]],
                 device: torch.device):
        self.parts = list(parts)
        self.ranges = list(ranges)
        self.device = device
        self._bounds = np.asarray([hi for _, hi in ranges[:-1]], np.int64)

    def owner_of(self, idx: np.ndarray) -> np.ndarray:
        return np.searchsorted(self._bounds, idx, side="right")

    def _gather_local(self, part, local: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def gather_view(self, idx) -> torch.Tensor:
        """Rows ``idx`` (a tensor or host array of full-space indices) as
        f32 ``idx.shape + row_shape`` on the view's device."""
        flat = _host_index(idx).reshape(-1)
        out = torch.zeros((flat.size,) + self.row_shape, dtype=torch.float32,
                          device=self.device)
        owner = self.owner_of(flat)
        for s, part in enumerate(self.parts):
            m = np.flatnonzero(owner == s)
            if part is None or m.size == 0:
                continue
            local = torch.from_numpy(
                (flat[m] - self.ranges[s][0]).astype(np.int32)).to(self.device)
            out[torch.from_numpy(m).to(self.device)] = self._gather_local(
                part, local)
        return out.reshape(tuple(np.shape(idx)) + self.row_shape)


class ShardedRows(_ShardedView):
    """Row-gatherable view over per-shard embedding tables (what
    ``ffm.gather_rows`` calls): an int8 part gathers through kernel K1 on
    its local indices, an f32 part by indexing. K1 works row by row, so the
    assembled rows equal one K1 over the whole table bit for bit.

    ``replica_parts`` (set by ``ShardRouter._refresh_fleet`` under the
    fleet lock, coherent with ``parts``) lists per slice the ``(replica,
    emb_part)`` pairs of every live replica: the fan-out load-balances,
    fails over and hedges across them without reading mutable fleet
    state."""

    replica_parts: Optional[List] = None

    def __init__(self, parts, ranges, row_shape: Tuple[int, ...],
                 device: torch.device):
        super().__init__(parts, ranges, device)
        self.row_shape = tuple(row_shape)

    def _gather_local(self, part, local):
        return ffm.gather_rows(part, local)


class ShardedLR(_ShardedView):
    """``gather_view`` over per-shard blocked-int8 (or f32) LR slices.
    Shard boundaries are LR-block aligned, so each slice's grids are
    exactly the full-space grids."""

    def _gather_local(self, part, local):
        return ffm.gather_lr(part, local).to(torch.float32)


# ---------------------------------------------------------------------------
# Partial / reduce stages
# ---------------------------------------------------------------------------

def _dot_k(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_k a[..., k] * b[..., k]`` as a fixed-order chain of elementwise
    ops: every entry's bits are independent of the other entries and of
    the shape (a batched GEMM or einsum may pick its reduction by shape)."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def _shard_partial_rows(cfg: FFMConfig, a_ctx, vc, vm, rows):
    """One shard's compacted candidate-entry partials from gathered f32
    rows ``rows`` (M, F, k) (padded bucket M). ``a_ctx`` (M, Fc, k) are the
    ctx-side facing vectors, ``vc`` (M, Fc) the context values, ``vm`` (M,)
    the candidate values. Returns ``terms`` (M, Fc), the entry's ctx-cand
    pair terms, and ``aa_rows`` (M, Fcand, k), the candidate-facing slice
    the router scatters for the cross-candidate reduce."""
    fc = cfg.context_fields
    terms = _dot_k(a_ctx, rows[:, :fc]) * vc * vm[:, None]
    return terms, rows[:, fc:]


def _shard_partial_q8(cfg: FFMConfig, a_ctx, vc, vm, part, local, out):
    """int8 twin of :func:`_shard_partial_rows`: kernel K1 gathers and
    dequantizes the owned rows ``local`` of the int8 table ``part`` into
    ``out[:M']`` (the rest of the padded bucket is zeroed), then the f32
    partial."""
    m = local.numel()
    rg_ops.gather_dequant_rows_q8(part["codes"], part["scale"],
                                  part["zero"], local, out=out[:m])
    out[m:].zero_()
    return _shard_partial_rows(cfg, a_ctx, vc, vm, out)


def _reduce_forward(cfg: FFMConfig, model: str, params, cached, pairs_xc,
                    aa_block, kv_b, lr_cand):
    """Finish the logits from the scattered partial terms: ``pairs_xc``
    (R, N, n_xc) ctx-cand terms, ``aa_block`` (R, N, Fcand, Fcand, k) the
    candidate rows' candidate-facing slices, reduced with the fixed-order
    chain, so the bits do not depend on the shard count that filled the
    block."""
    f0 = cfg.context_fields
    (pi, pj), _, _, aa = ffm.on_device(ffm.pair_split, (cfg,), kv_b.device)
    ai, aj = pi[aa] - f0, pj[aa] - f0
    eai = aa_block[:, :, ai, aj]
    eaj = aa_block[:, :, aj, ai]
    va = kv_b[:, :, ai] * kv_b[:, :, aj]
    pairs_aa = _dot_k(eai, eaj) * va
    return _finish_candidates(cfg, model, params, cached, pairs_xc, pairs_aa,
                              lr_cand)


# ---------------------------------------------------------------------------
# Replica health (circuit breaker)
# ---------------------------------------------------------------------------

class ReplicaHealth:
    """Per-replica circuit breaker: ``healthy -> suspect -> dead`` on
    consecutive strikes (call failures and lost hedges), with exponential
    backoff between suspect retries; ``dead`` replicas leave the read
    rotation until the prober revives them (``dead -> probing ->
    healthy``). One small lock per breaker keeps the fleet lock off the
    per-call path."""

    HEALTHY, SUSPECT, DEAD, PROBING = "healthy", "suspect", "dead", "probing"

    def __init__(self, max_strikes: int = 3, backoff_s: float = 0.05):
        self.max_strikes = max_strikes
        self.backoff_s = backoff_s
        self.state = self.HEALTHY  # guarded-by: _lock
        self.strikes = 0           # guarded-by: _lock
        self.retry_at = 0.0        # guarded-by: _lock
        self._lock = threading.Lock()

    def record_success(self) -> None:
        with self._lock:
            self.state, self.strikes, self.retry_at = self.HEALTHY, 0, 0.0

    def record_strike(self, now: float) -> None:
        with self._lock:
            self.strikes += 1
            self.state = (self.DEAD if self.strikes >= self.max_strikes
                          else self.SUSPECT)
            self.retry_at = now + self.backoff_s * 2 ** min(self.strikes - 1, 6)

    def begin_probe(self) -> bool:
        with self._lock:
            if self.state != self.DEAD:
                return False
            self.state = self.PROBING
            return True

    def fail_probe(self, now: float) -> None:
        with self._lock:
            self.state = self.DEAD
            self.strikes += 1
            self.retry_at = now + self.backoff_s * 2 ** min(self.strikes - 1, 6)

    def available(self, now: float) -> bool:
        """May this replica take traffic now? Healthy always; suspect only
        past its backoff; dead and probing never (the prober owns those)."""
        with self._lock:
            if self.state == self.HEALTHY:
                return True
            return self.state == self.SUSPECT and now >= self.retry_at


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------

class ShardRouter(InferenceEngine):
    """Fleet front end: N hash-space-sharded engines (M replicas each)
    behind one :class:`InferenceEngine` surface.

    The router *is* an engine: ``score`` / ``score_batch``, the prefix
    cache, dedup, buckets, warmup and stats are inherited and run on the
    **assembled view** (virtual params whose gather tables are
    :class:`ShardedRows` / :class:`ShardedLR` over the live shards). Only
    :meth:`_candidates_forward` is replaced by the scatter-gather fan-out
    on the fleet's one shared :class:`ScoringPool`. Router and shards pin
    ``parallel=1``: the router's parallelism is the shard fan-out.

    ``replicas`` engines per slice; ``hedge_ms`` pins the straggler
    threshold (default 3x the router's p99, floored at 50 ms);
    ``probe_interval_s`` paces the prober; ``faults`` takes a
    :class:`FaultPlan`. ``device=None`` means the card. The router's own
    engine and the shards take the engine's defaults (``backend="cuda"``,
    the prefix cache's stride 4 at the router; no prefix checkpoints and
    64 entries at the shards, whose own scoring serves direct traffic
    only)."""

    def __init__(self, cfg: FFMConfig, model: str = "deepffm", *,
                 n_shards: int = 2, params=None, device: DeviceLike = None,
                 quantized: bool = True, replicas: int = 1,
                 hedge_ms: Optional[float] = None,
                 probe_interval_s: float = 0.2,
                 faults: Optional[FaultPlan] = None):
        self.topology = ShardTopology.build(cfg, model, n_shards,
                                            replicas=replicas)
        # ONE pool for the whole fleet: the fan-out's per-shard (and hedge)
        # tasks run here, and every replica engine is built around it
        self._pool = ScoringPool(n_shards * replicas)
        self._fleet: List[List[Optional[InferenceEngine]]] = [  # guarded-by: _fleet_lock
            [InferenceEngine(self.topology.shard_cfg(s), model,
                             device=device, quantized=quantized,
                             cache_entries=64, prefix_stride=None,
                             host_gather=False, parallel=1,
                             scoring_pool=self._pool)
             for _ in range(replicas)]
            for s in range(n_shards)]
        self._active: List[int] = [0] * n_shards  # guarded-by: _fleet_lock
        self._rr: List[int] = [0] * n_shards      # round-robin read cursor
        self._health: List[List[ReplicaHealth]] = [
            [ReplicaHealth() for _ in range(replicas)]
            for _ in range(n_shards)]
        self.faults = faults
        self.hedge_ms = hedge_ms
        self.probe_interval_s = probe_interval_s
        self.degraded = False
        self._fleet_lock = threading.Lock()
        self._fleet_vector: Optional[Tuple] = None  # guarded-by: _fleet_lock
        self._last_primary = None  # last live params; guarded-by: _fleet_lock
        self._call_tl = threading.local()  # per-batch fault-outcome flags
        self._stream_tl = threading.local()  # a pool thread's CUDA stream
        self._prober: Optional[threading.Thread] = None  # guarded-by: _fleet_lock
        self._prober_stop = threading.Event()
        # entry -> pair-position map: the entry (r, n, j) contributes one
        # term per context field i, at the xc position of pair (i, f0 + j)
        (pi, pj), _, xc, _ = ffm.pair_split(cfg)
        fc, fcand = cfg.context_fields, cfg.n_fields - cfg.context_fields
        self._xcpos = np.empty((fc, fcand), np.int64)
        self._xcpos[pi[xc], pj[xc] - fc] = np.arange(xc.size)
        # the router's own surface runs on the assembled view: it never
        # quantizes (the shards own their tables)
        super().__init__(cfg, model, params=None, device=device,
                         quantized=False, host_gather=False, parallel=1,
                         scoring_pool=self._pool)
        if params is not None:
            self.install_params(params)

    # -- fleet weight management -------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self._fleet)

    @property
    def shards(self) -> List[Optional[InferenceEngine]]:
        """Each slice's serving replica (``None``: every replica of the
        slice is gone)."""
        return [None if a < 0 else row[a]
                for row, a in zip(self._fleet, self._active)]

    def fleet_generations(self) -> List[Optional[Tuple[int, int]]]:
        """Per slice ``(generation, weights_version)`` of the serving
        replica; ``None`` for a dead slice."""
        return [None if s is None else (s.generation, s.weights_version)
                for s in self.shards]

    def replica_generations(self) -> List[List[Optional[Tuple[int, int]]]]:
        """Per slice and replica ``(generation, weights_version)``
        (``None``: killed slot)."""
        return [[None if e is None else (e.generation, e.weights_version)
                 for e in row] for row in self._fleet]

    def _fleet_vector_now(self) -> Tuple:
        return tuple(tuple(None if e is None
                           else (e.generation, e.weights_version)
                           for e in row) for row in self._fleet)

    def install_params(self, params) -> None:
        """Shard a full-space f32 tree across the fleet and republish the
        assembled view. Every replica of slice ``s`` quantizes the same slice
        (deterministic, so siblings start byte-identical, and byte-identical
        to slicing a full-space quantization)."""
        for s, row in enumerate(self._fleet):
            local = self.topology.shard_params(params, s)
            for eng in row:
                if eng is not None:
                    eng.install_params(local)
        self._refresh_fleet(force=True)

    def kill_shard(self, shard: int, replica: Optional[int] = None) -> None:
        """Take one replica down, by default the slice's serving replica. A
        sibling is promoted at the refresh (scores stay exact); only when
        the slice's last replica dies do its rows score as zeros, with
        ``degraded`` latched. The victim's update pipe is killed without
        blocking (a racing ``flush`` wakes). Killing a dead slot is a
        no-op."""
        with self._fleet_lock:
            r = self._active[shard] if replica is None else replica
            victim = None if r < 0 else self._fleet[shard][r]
            if victim is not None:
                self._fleet[shard][r] = None
        if victim is None:
            if all(e is None for e in self._fleet[shard]):
                self.degraded = True
            return
        pipe = victim._pipe
        if pipe is not None:
            pipe.kill()
        victim.close()
        self._refresh_fleet(force=True)

    def rotate_shard(self, shard: int, **rotate_kw) -> InferenceEngine:
        """Swap the slice's serving replica for a successor built off the
        request path (:meth:`InferenceEngine.rotate`), re-pointing the
        replica's update pipe at it under the pipe's ingest lock, so the
        receiver's byte chain (and the delta sequence) continues unbroken.

        Lock order at the re-point: ``pipe._ingest_lock`` (rank 20) then
        ``succ._pipe_lock`` (rank 30), the pair declared in
        ``analysis/lock_order.py``. The fleet-slot swap happens after the
        ingest lock is released: ``_fleet_lock`` (rank 10) ranks below it."""
        r = self._active[shard]
        old = None if r < 0 else self._fleet[shard][r]
        if old is None:
            raise ValueError(f"shard {shard} is dead")
        succ = old.rotate(**rotate_kw)
        pipe = old._pipe
        if pipe is not None:
            with pipe._ingest_lock:       # rank 20: freezes frame ingestion
                pipe._engine = succ
                with succ._pipe_lock:     # rank 30: ingest -> pipe is declared
                    succ._pipe = pipe
        with self._fleet_lock:
            self._fleet[shard][r] = succ
        self._refresh_fleet(force=True)
        return succ

    def _refresh_fleet(self, force: bool = False) -> None:
        """Rebuild the assembled view iff the fleet generation vector moved;
        publishing bumps the router generation (stamping the prefix cache).

        Replica promotion happens here: every slice's serving slot points
        at a live replica (one holding params first). Once weights were
        installed the refresh never raises for fleet health: with every
        replica dead it serves the last head leaves over all-zero tables."""
        vector = self._fleet_vector_now()
        with self._fleet_lock:
            if not force and vector == self._fleet_vector:
                return
            for s, row in enumerate(self._fleet):
                a = self._active[s]
                if not (0 <= a < len(row) and row[a] is not None
                        and row[a].params is not None):
                    alive = [r for r, e in enumerate(row) if e is not None]
                    armed = [r for r in alive if row[r].params is not None]
                    self._active[s] = (armed or alive or [-1])[0]
            if any(all(e is None for e in row) for row in self._fleet):
                self.degraded = True
            actives = self.shards
            parts = [None if e is None else e.params for e in actives]
            live = [p for p in parts if p is not None]
            if live:
                primary = live[0]
                self._last_primary = primary
            elif self._last_primary is not None:
                primary = self._last_primary
                self.degraded = True
            else:
                raise RuntimeError("every shard is dead or weightless")
            cfg = self.cfg
            virtual = {k: v for k, v in primary.items()
                       if k not in ("ffm", "lr")}
            emb = ShardedRows(
                [None if p is None else p["ffm"]["emb"] for p in parts],
                self.topology.ranges, (cfg.n_fields, cfg.k), self.device)
            # the fan-out reads only this snapshot (and the breakers), never
            # the mutable fleet lists
            emb.replica_parts = [
                [(r, e.params["ffm"]["emb"]) for r, e in enumerate(row)
                 if e is not None and e.params is not None]
                for row in self._fleet]
            virtual["ffm"] = {"emb": emb}
            virtual["lr"] = {
                "w": ShardedLR(
                    [None if p is None else p["lr"]["w"] for p in parts],
                    self.topology.ranges, self.device),
                "b": primary["lr"]["b"]}
            self._fleet_vector = vector
            # one-reference publish; _weights_raw directly (the property
            # getter re-enters _refresh_fleet, and _fleet_lock is held)
            self._weights_raw = (virtual, self._weights_raw[1] + 1)
            self.weights_version = max(
                (e.weights_version for e in actives if e is not None),
                default=self.weights_version)

    def _maybe_refresh(self) -> None:
        if self._fleet_vector_now() != self._fleet_vector:
            self._refresh_fleet()

    # the scoring path snapshots `self._weights`: route that read through a
    # fleet-vector check, so shard publishes (async update pipes) become
    # visible at the next batch
    @property
    def _weights(self):
        if self._fleet_vector is not None:
            self._maybe_refresh()
        return self._weights_raw

    @_weights.setter
    def _weights(self, value):
        self._weights_raw = value

    # -- update fan-out ------------------------------------------------------
    def configure_fanout(self, manifests: Sequence, like_params) -> None:
        """Per-shard decode defaults: shard ``s``'s pipes decode against
        ``manifests[s]`` (``ShardedSender.manifests``) and ``like_params``'s
        structure and dtypes."""
        missing = [s for s, m in enumerate(manifests) if m is None]
        if missing:
            # a pipe with no manifest would reject every frame on its
            # ingest thread, and the fleet would silently never advance
            raise ValueError(
                f"no manifest for shard(s) {missing}: prime the ShardedSender "
                "(or run a round) before configure_fanout")
        for row, manifest in zip(self._fleet, manifests):
            for eng in row:
                if eng is not None:
                    eng.update_pipe(manifest=manifest,
                                    like_params=like_params)

    def submit_updates(self, updates: Sequence[Optional[bytes]]) -> int:
        """Fan one round's per-shard frames out to the fleet's update pipes
        (asynchronous, backpressure per pipe), teeing each slice's frame to
        **every** live replica: each runs its own receiver chain over the
        same frames, which keeps siblings byte-identical. Returns the number
        of slices that accepted the frame on at least one replica."""
        n = 0
        for row, frame in zip(self._fleet, updates):
            if frame is None:
                continue
            ok = False
            for eng in row:
                if eng is None:
                    continue
                try:
                    ok |= bool(eng.submit_update(frame))
                except RuntimeError:  # killed or closed pipe == dead slot
                    continue
            n += ok
        return n

    def flush_updates(self, timeout: Optional[float] = 30.0) -> List[
            Optional[Tuple[int, int]]]:
        """Wait until every live replica published its pending frames,
        refresh the assembled view and return the generation vector."""
        for row in self._fleet:
            for eng in row:
                if eng is not None and eng._pipe is not None:
                    eng._pipe.flush(timeout)
        self._maybe_refresh()
        return self.fleet_generations()

    def frame_errors(self) -> List[Optional[str]]:
        """Per-slice NACK latch: the first replica-reported frame error,
        ``None`` for a clean slice."""
        out: List[Optional[str]] = []
        for row in self._fleet:
            err = None
            for eng in row:
                pipe = None if eng is None else eng._pipe
                if pipe is not None and pipe.stats.last_frame_error:
                    err = pipe.stats.last_frame_error
                    break
            out.append(err)
        return out

    def resync_shard(self, shard: int, sender) -> int:
        """Answer a NACK: the sender rebuilds the slice's full frame
        (``ShardedSender.resync``), teed to every live replica, whose NACK
        latches clear. Returns the number of replicas that accepted it."""
        frame = sender.resync(shard)
        n = 0
        for eng in self._fleet[shard]:
            if eng is None:
                continue
            try:
                accepted = bool(eng.submit_update(frame))
            except RuntimeError:
                continue
            if accepted:
                pipe = eng._pipe
                if pipe is not None:
                    pipe.stats.last_frame_error = None
                n += 1
        return n

    # -- resource accounting -------------------------------------------------
    @property
    def resident_weight_bytes(self) -> int:
        """Every live replica's resident bytes (the head leaves replicate
        per engine, the tables split per slice)."""
        return sum(e.resident_weight_bytes
                   for row in self._fleet for e in row if e is not None)

    def shard_resident_bytes(self) -> List[int]:
        return [sum(e.resident_weight_bytes for e in row if e is not None)
                for row in self._fleet]

    # -- scoring: scatter partials / gather the reduction --------------------
    def _forward_args(self, params, stacked, ki_b: np.ndarray,
                      kv_b: np.ndarray, grids=None, out=None):
        """The router's candidate forward *is* the scatter-gather fan-out,
        so the engine's argument builder returns it whole. ``grids`` /
        ``out`` are unused: the router never gathers on the host (its
        shards hold the tables and gather on the device)."""
        return self._scatter_gather_forward, (params, stacked, ki_b, kv_b)

    def _tl_flags(self):
        """This thread's per-batch fault-outcome flags (warmup drives the
        forward without going through ``score_batch``)."""
        tl = self._call_tl
        if not hasattr(tl, "degraded"):
            tl.degraded = False
            tl.hedged = 0
            tl.failovers = 0
            tl.deadline_missed = False
        return tl

    def _hedge_threshold_s(self) -> float:
        """Straggler threshold before a slice call is hedged: ``hedge_ms``
        if pinned, else 3x the router's p99 floored at 50 ms."""
        if self.hedge_ms is not None:
            return self.hedge_ms / 1e3
        return max(0.05, 3.0 * self.stats.latency_ms(99.0) / 1e3)

    def score_batch(self, requests: Sequence[Tuple], *,
                    deadline_ms: Optional[float] = None) -> List[np.ndarray]:
        """Engine surface plus the fleet's fault semantics: due fault-plan
        kills fire at the batch boundary, and the batch's degraded / hedge /
        failover / deadline outcomes fold into ``stats``."""
        if self.faults is not None:
            for s, r in self.faults.next_round():
                self.kill_shard(s, r)
        tl = self._tl_flags()
        tl.degraded = False
        tl.hedged = 0
        tl.failovers = 0
        tl.deadline_missed = False
        out = super().score_batch(requests, deadline_ms=deadline_ms)
        with self._lock:
            st = self.stats
            st.last_degraded = bool(tl.degraded)
            if tl.degraded:
                st.degraded_responses += 1
            if tl.deadline_missed:
                st.deadline_misses += 1
            st.hedged_calls += tl.hedged
            st.failovers += tl.failovers
        return out

    def _task_stream(self):
        """This pool thread's own CUDA stream (``None`` on the CPU)."""
        if self.device.type != "cuda":
            return None
        stream = getattr(self._stream_tl, "stream", None)
        if stream is None:
            stream = self._stream_tl.stream = torch.cuda.Stream(self.device)
        return stream

    def _scatter_gather_forward(self, params, stacked, ki_b, kv_b):
        cfg = self.cfg
        fc, fcand, k = cfg.context_fields, cfg.n_fields - cfg.context_fields, cfg.k
        rb, nb = ki_b.shape[:2]
        dev = self.device
        emb_view: ShardedRows = params["ffm"]["emb"]
        kv = torch.from_numpy(kv_b).to(dev)
        lr_cand = torch.sum(ffm.gather_lr(params["lr"]["w"], ki_b) * kv,
                            dim=-1)
        owner = emb_view.owner_of(ki_b.reshape(-1)).reshape(ki_b.shape)
        stacked_emb = stacked["emb"].to(torch.float32)
        stacked_val = stacked["val"]
        caller = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        ready = None
        if caller is not None:
            # the shard tasks read these on their own streams
            ready = torch.cuda.Event()
            ready.record(caller)
        tl = self._tl_flags()
        deadline = self._deadline()
        hedge_s = self._hedge_threshold_s()
        replica_rows = emb_view.replica_parts
        if replica_rows is None:  # a view built outside _refresh_fleet
            replica_rows = [[] if p is None else [(0, p)]
                            for p in emb_view.parts]

        def shard_task(s: int, replica: int, part):
            # one replica's partial-sum "call": fault hooks first, then the
            # local gather + fixed-order partial. Siblings hold byte-identical
            # tables, so whichever replica answers, the bits are the same.
            if self.faults is not None:
                self.faults.on_replica_call(s, replica)
            sel = np.flatnonzero((owner == s).reshape(-1))
            r_m, rem = np.divmod(sel, nb * fcand)
            n_m, j_m = np.divmod(rem, fcand)
            m = sel.size
            mb = self.plan.bucket(m, minimum=self.plan.min_bucket)
            stream = self._task_stream()
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            quant = Q.is_row_quantized(part)
            buf = done = None
            try:
                with ctx:
                    if stream is not None:
                        stream.wait_event(ready)
                        for t in (stacked_emb, stacked_val, kv):
                            t.record_stream(stream)

                    def up(a):
                        return torch.from_numpy(a).to(dev)

                    r_t, n_t, j_t = up(r_m), up(n_m), up(j_m)
                    local = up((ki_b[r_m, n_m, j_m]
                                - emb_view.ranges[s][0]).astype(np.int32))

                    def pad(x):
                        if x.shape[0] == mb:
                            return x
                        return torch.cat([x, x.new_zeros(
                            (mb - x.shape[0],) + tuple(x.shape[1:]))])

                    a_ctx = pad(stacked_emb[r_t, :, fc + j_t])   # (M, Fc, k)
                    vc = pad(stacked_val[r_t])                    # (M, Fc)
                    vm = pad(kv[r_t, n_t, j_t])                   # (M,)
                    # the rows land in a pool-recycled buffer, released on
                    # every exit with the event behind its last use
                    buf = self._pool.acquire((mb, cfg.n_fields, k),
                                             torch.float32, dev)
                    if stream is not None:
                        buf.record_stream(stream)
                    if quant:
                        terms, aa_rows = _shard_partial_q8(
                            cfg, a_ctx, vc, vm, part, local, buf)
                    else:
                        torch.index_select(part, 0, local, out=buf[:m])
                        buf[m:].zero_()
                        terms, aa_rows = _shard_partial_rows(
                            cfg, a_ctx, vc, vm, buf)
                    terms, aa_rows = terms[:m], aa_rows[:m].clone()
                    if stream is not None:
                        done = torch.cuda.Event()
                        done.record(stream)
            finally:
                if buf is not None:
                    self._pool.release(buf, done)
                if done is not None:
                    done.synchronize()
            return r_m, n_m, j_m, terms, aa_rows

        # launch one call per owning slice (round-robin over available
        # replicas); the collection below hedges and fails over per slice
        now0 = time.monotonic()
        inflight: List[Optional[dict]] = []
        for s in range(len(emb_view.parts)):
            if not np.any(owner == s):
                inflight.append(None)
                continue
            cands = [(r, p) for r, p in replica_rows[s]
                     if self._health[s][r].available(now0)]
            if not cands:
                cands = list(replica_rows[s])  # all breakered: still try
            if not cands:
                # the slice owns entries but has no live replica: its rows
                # contribute zeros and the response is flagged
                tl.degraded = True
                inflight.append(None)
                continue
            rot = self._rr[s] % len(cands)
            self._rr[s] += 1
            cands = cands[rot:] + cands[:rot]
            fut = self._pool.submit(shard_task, s, cands[0][0], cands[0][1])
            inflight.append({"s": s, "cands": cands, "next": 1,
                             "pending": {fut: cands[0][0]},
                             "start": time.monotonic(), "hedged": False})

        def collect(st):
            """First success wins for one slice: a failed call fails over to
            the next untried replica, a straggler past the hedge threshold
            races a sibling (once), and a blown deadline abandons the slice
            (stragglers finish on pool threads and recycle their own
            buffers). Returns the partial result or None (zeros,
            degraded)."""
            s = st["s"]
            while st["pending"]:
                now = time.monotonic()
                timeout = None
                if deadline is not None:
                    timeout = deadline - now
                    if timeout <= 0:
                        tl.deadline_missed = True
                        tl.degraded = True
                        return None
                if not st["hedged"] and st["next"] < len(st["cands"]):
                    until_hedge = st["start"] + hedge_s - now
                    timeout = (until_hedge if timeout is None
                               else min(timeout, until_hedge))
                done, _ = _futures_wait(
                    list(st["pending"]),
                    timeout=None if timeout is None else max(timeout, 0.0),
                    return_when=FIRST_COMPLETED)
                now = time.monotonic()
                for fut in done:
                    replica = st["pending"].pop(fut)
                    if fut.exception() is None:
                        self._health[s][replica].record_success()
                        return fut.result()
                    self._health[s][replica].record_strike(now)
                    self._ensure_prober()
                    if st["next"] < len(st["cands"]):
                        r2, p2 = st["cands"][st["next"]]
                        st["next"] += 1
                        tl.failovers += 1
                        st["pending"][self._pool.submit(
                            shard_task, s, r2, p2)] = r2
                if (not done and not st["hedged"]
                        and st["next"] < len(st["cands"])
                        and now - st["start"] >= hedge_s):
                    # straggler: strike it (breaker food) and race a sibling
                    for straggler in st["pending"].values():
                        self._health[s][straggler].record_strike(now)
                    self._ensure_prober()
                    r2, p2 = st["cands"][st["next"]]
                    st["next"] += 1
                    tl.hedged += 1
                    st["hedged"] = True
                    st["pending"][self._pool.submit(
                        shard_task, s, r2, p2)] = r2
            tl.degraded = True  # every attempted replica failed
            return None

        n_xc = fc * fcand
        pairs_xc = torch.zeros((rb, nb, n_xc), dtype=torch.float32, device=dev)
        aa_block = torch.zeros((rb, nb, fcand, fcand, k), dtype=torch.float32,
                               device=dev)
        # fixed slice order; every entry's positions are written by exactly
        # one slice (a non-accumulating index_put_ into disjoint positions)
        for st in inflight:
            res = None if st is None else collect(st)
            if res is None:
                continue
            r_m, n_m, j_m, terms, aa_rows = res
            if caller is not None:
                # made on a task stream, read on this one
                terms.record_stream(caller)
                aa_rows.record_stream(caller)

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            r_t, n_t = up(r_m), up(n_m)
            pairs_xc[r_t[:, None], n_t[:, None],
                     up(self._xcpos[:, j_m].T)] = terms
            aa_block[r_t, n_t, up(j_m)] = aa_rows
        return _reduce_forward(cfg, self.model, params, stacked, pairs_xc,
                               aa_block, kv, lr_cand)

    # -- replica health / background prober ----------------------------------
    def _ensure_prober(self) -> None:
        """Start the daemon prober the first time a breaker opens (an idle
        fleet never pays for the thread)."""
        if self._prober is not None and self._prober.is_alive():
            return
        with self._fleet_lock:
            if ((self._prober is not None and self._prober.is_alive())
                    or self._prober_stop.is_set()):
                return
            self._prober = threading.Thread(
                target=self._probe_loop, name="shard-prober", daemon=True)
            self._prober.start()

    def _probe_loop(self) -> None:
        """Periodically probe DEAD replicas (through the fault hook, so
        injected failures keep them dead until the plan exhausts) and
        return survivors to the read rotation."""
        while not self._prober_stop.wait(self.probe_interval_s):
            now = time.monotonic()
            for s, row in enumerate(self._fleet):
                for r, eng in enumerate(row):
                    h = self._health[s][r]
                    if (h.state != ReplicaHealth.DEAD or now < h.retry_at
                            or eng is None or eng.params is None):
                        continue
                    if not h.begin_probe():
                        continue
                    try:
                        if self.faults is not None:
                            self.faults.on_replica_call(s, r)
                        h.record_success()
                    except Exception:
                        h.fail_probe(time.monotonic())

    def close(self) -> None:
        """Shut the fleet down: stop the prober, kill every replica's update
        pipe (non-blocking), drop the shared pool from the router and every
        replica, and shut the pool down. A closed router no longer
        scores."""
        self._prober_stop.set()
        prober = self._prober
        if prober is not None:
            prober.join(timeout=5.0)
        with self._lock:
            self._scoring_pool = None
        for row in self._fleet:
            for eng in row:
                if eng is None:
                    continue
                with eng._lock:
                    eng._scoring_pool = None
                if eng._pipe is not None:
                    eng._pipe.kill()
        self._pool.shutdown()

    # -- oracle --------------------------------------------------------------
    def materialized_params(self):
        """The live shards' tables concatenated back into one full-space
        tree on the router's device (dead shards: zero rows) — the router's
        oracle weights, exact on a quantized fleet (per-shard grids are
        slices of the full-space grids)."""
        parts = [None if s is None else s.params for s in self.shards]
        live = [p for p in parts if p is not None]
        if not live:
            raise RuntimeError("every shard is dead or weightless")
        primary = live[0]
        cfg, dev = self.cfg, self.device

        def zeros(*shape, dt=torch.float32):
            return torch.zeros(shape, dtype=dt, device=dev)

        def emb_part(p, lo, hi):
            if p is not None:
                return p["ffm"]["emb"]
            n = hi - lo
            if Q.is_row_quantized(live[0]["ffm"]["emb"]):
                return {"codes": zeros(n, cfg.n_fields, cfg.k, dt=torch.int8),
                        "scale": torch.ones(n, device=dev),
                        "zero": zeros(n)}
            return zeros(n, cfg.n_fields, cfg.k)

        def lr_part(p, lo, hi):
            if p is not None:
                return p["lr"]["w"]
            n = hi - lo
            like = live[0]["lr"]["w"]
            if Q.is_block_quantized(like):
                b = int(like["block"])
                return {"codes": zeros(n, dt=torch.int8),
                        "scale": torch.ones(-(-n // b), device=dev),
                        "zero": zeros(-(-n // b)), "block": b}
            return zeros(n)

        def dense(t, blocked):
            if blocked:
                return torch.from_numpy(Q.dequantize_blocks(t)).to(dev)
            return torch.from_numpy(Q.dequantize_rows(t)).to(dev)

        ranges = self.topology.ranges
        embs = [emb_part(p, lo, hi) for p, (lo, hi) in zip(parts, ranges)]
        lrs = [lr_part(p, lo, hi) for p, (lo, hi) in zip(parts, ranges)]
        out = {kk: v for kk, v in primary.items() if kk not in ("ffm", "lr")}
        if all(Q.is_row_quantized(e) for e in embs):
            out["ffm"] = {"emb": {key: torch.cat([e[key] for e in embs])
                                  for key in ("codes", "scale", "zero")}}
        else:
            out["ffm"] = {"emb": torch.cat(
                [dense(e, False) if Q.is_row_quantized(e) else e
                 for e in embs])}
        if all(Q.is_block_quantized(w) for w in lrs):
            out["lr"] = {"w": {key: torch.cat([w[key] for w in lrs])
                               for key in ("codes", "scale", "zero")},
                         "b": primary["lr"]["b"]}
            out["lr"]["w"]["block"] = int(lrs[0]["block"])
        else:
            out["lr"] = {"w": torch.cat(
                [dense(w, True) if Q.is_block_quantized(w) else w
                 for w in lrs]), "b": primary["lr"]["b"]}
        return out

    def score_uncached(self, ctx_idx, ctx_val, cand_idx, cand_val,
                       use_backend: bool = False) -> torch.Tensor:
        """Full-forward oracle against the materialized fleet tables (the
        assembled view's leaves are not tables the forward can index)."""
        self._require_params()
        ci = np.asarray(ctx_idx, np.int32)
        ki = np.asarray(cand_idx, np.int32)
        self._check_indices(ci, ki)
        n, fc = ki.shape[0], self.cfg.context_fields
        idx = np.concatenate([np.broadcast_to(ci, (n, fc)), ki], axis=1)
        val = np.concatenate(
            [np.broadcast_to(np.asarray(ctx_val, np.float32), (n, fc)),
             np.asarray(cand_val, np.float32)], axis=1)
        interactions_fn = None
        if use_backend and self.backend == "cuda":
            from repro_torch.kernels.ffm_interaction import ops as ffm_ops

            interactions_fn = ffm_ops.interactions
        return deepffm.forward(
            self.cfg, self.materialized_params(),
            torch.from_numpy(idx).to(self.device),
            torch.from_numpy(val).to(self.device),
            self.model, interactions_fn=interactions_fn)
