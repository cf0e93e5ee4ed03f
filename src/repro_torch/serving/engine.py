"""Serving engine, staged and fused paths (port of ``repro/serving/engine.py``).

One request is a context plus N candidates and yields N logits. The engine
composes the paper's tricks in one scoring path:

* **§5 context cache** — a prefix tree over ``(idx, val)`` field tokens
  (:mod:`repro_torch.serving.prefix_cache`). A lookup reuses the deepest
  cached prefix partial and only the context *tail* is computed, on the
  device, with :func:`ffm.extend_context_prefix` (int8 tables gather their
  tail rows through the row-gather kernel). Entries carry the weight
  generation they were computed under.
* **§5 candidate dedup** — :meth:`InferenceEngine.score_batch` scores each
  unique ``(context, candidate)`` row of a microbatch once and scatters the
  scores back per request.
* **§5 hot loop** — with ``backend="cuda"`` the candidate pair columns come
  from the candidate-block kernels (``kernels/ffm_interaction``), which
  consume the cached context partials; ``backend="reference"`` computes them
  with plain tensor code (the oracle path, as in the JAX engine).
* **§6 quantized serving** — ``quantized=True`` keeps the embedding table as
  int8 rows with per-row ``(scale, zero)`` grids and the LR table as blocked
  int8; the candidate kernel dequantizes in registers, so the f32 candidate
  block never exists in device memory.
* **§6 host pre-gather** — ``host_gather=True`` gathers each padded block's
  candidate codes (or f32 rows), ``(scale, zero)`` grids and LR terms on
  the host, with the packed numpy gather
  (``kernels/row_gather/ops.py:gather_codes_np``) over a host mirror of the
  tables, uploads the block and scores it through
  :func:`batched_candidates_forward_q8` / ``_rows`` (or the fused forwards):
  the kernels get the same bytes (the LR terms are summed on the device,
  as the device gather sums them), so the scores equal the device-gather
  path's bit for bit, and no device gather reads the candidate table. The
  mirror is a zero-copy view on a CPU device and, on the card, pinned host
  memory copied from the device once per published params object
  (:meth:`InferenceEngine._host_weights`). Grids are gathered once per
  unique deduped row (:meth:`InferenceEngine._compact_grids`). This is the
  paper's CPU-deployment gather; ``host_gather=None`` takes it on a CPU
  device past the gather cliff (``row_gather.ops.use_host_gather``) and
  never on the card.
* **Fused bucket scoring (§5 x §6)** — ``InferenceEngine(fused=True)``
  (``"ffm"`` model only) collapses the staged chain — context-tail pairs,
  candidate dot matrices, pair-vector scatter, additive head — into one
  kernel launch per padding bucket (:func:`fused_candidates_forward_q8` /
  ``_rows``): context resolution only gathers rows
  (``ffm.fused_context_state``); the kernel computes the context pairs a
  depth-p cached prefix still owes, accumulates int8 cand-cand dots exactly
  in int32 and returns logits plus each row's ctx pair matrix, from which
  full-depth prefix states are rebuilt and inserted after scoring
  (``ffm.prefix_state_from_dots``), so the cache keeps learning. Against
  the staged path on the same tables the deviation is f32 reassociation,
  bounded by ``quantization.fused_logit_tolerance``. ``deepffm`` heads and
  ``score_uncached`` stay staged.
* **§3/§6 hot weight swap** — :meth:`InferenceEngine.apply_update` /
  :meth:`~InferenceEngine.submit_update` ingest trainer frames through the
  engine's :class:`~repro_torch.serving.update_pipe.UpdatePipe` (decode and
  dequantize on the card, requantize only a delta's touched rows) and
  publish ``(params, generation)`` atomically. The prefix cache keeps its
  trie: entries carry their generation and stale ones are recomputed.

Candidate counts pad to power-of-two buckets and the requests of a
microbatch stack into one forward. Host-side request bookkeeping (tokens,
dedup, chunking, scatter-back) is numpy, exactly as in the JAX engine; the
tables, cached states and all scoring arithmetic live on the device (a
host-gather engine also gathers the candidate blocks on the host).

**Parallel scoring.** ``InferenceEngine(parallel=N)`` splits a
microbatch's deduped candidate chunks into contiguous per-worker spans, each
padded to its own power-of-two row bucket, and pipelines them through a
:class:`ScoringPool`: pool threads prepare span *k+1* (padding, stacking the
context states) while the caller thread launches span *k*. Spans are
launched and reassembled in fixed chunk order, every candidate forward's
per-row output is invariant to the row bucket, and all spans score against
the batch's one ``(params, generation)`` snapshot, so the scores are
bit-identical for every worker count. Every span is enqueued on the
caller's stream, so the pipeline needs no cross-stream synchronization. On
a host-gather engine the pool threads also run span *k+1*'s host gather,
into pinned buffers from :meth:`ScoringPool.acquire`; each block uploads
with ``non_blocking=True``, and its buffer goes back to the pool with the
event recorded after the upload, so it is not reused while the copy is in
flight. A
:class:`~repro_torch.serving.shard_router.ShardRouter` threads one shared
pool through all its shards (``scoring_pool=``); shards and the router pin
``parallel=1``, the router's parallelism being the shard fan-out.

**Deadlines and degraded responses.** ``score_batch(deadline_ms=)``
attaches a wall-clock budget that the ``ShardRouter`` plumbs through its
scatter-gather: a slice with no answer at the deadline contributes zero
rows, and the response is flagged (``ServeStats.last_degraded``,
``degraded_responses``, ``deadline_misses``), never raised. A single engine
never degrades: its one forward always runs to completion.

**Roofline.** :meth:`InferenceEngine.lower_candidates_forward` returns the
deployed candidate forward and its arguments at one bucket, built by the
same :meth:`InferenceEngine._forward_args` that requests run, and
:meth:`InferenceEngine.host_gather_bytes` the host pre-gather's analytic
bytes; ``launch/roofline.py:serving_roofline`` counts the one and adds the
other.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.config import FFMConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.convert import to_device
from repro_torch.core import deepffm, ffm
from repro_torch.core import quantization as Q
from repro_torch.serving.prefix_cache import (PrefixCache,
                                              context_from_tokens,
                                              context_tokens)
from repro_torch.serving.update_pipe import UpdatePipe


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

@dataclass
class ServeStats:
    """Serving counters + a bounded window of per-request latencies.

    ``candidates`` counts *requested* rows; ``rows_scored`` counts rows that
    actually went through the forward after cross-request dedup (pre-padding).
    ``ctx_partials_full`` counts contexts computed from scratch (no cached
    prefix) and ``ctx_tail_fields`` the total context fields actually
    computed.
    """

    requests: int = 0
    candidates: int = 0
    rows_scored: int = 0
    seconds: float = 0.0
    updates_applied: int = 0
    update_bytes: int = 0
    ctx_partials_full: int = 0
    ctx_tail_fields: int = 0
    # fault-tolerance counters, set by the ShardRouter
    degraded_responses: int = 0  # responses with >=1 zero-rows slice
    deadline_misses: int = 0     # responses that gave a slice up at deadline
    hedged_calls: int = 0        # shard calls re-issued to a sibling replica
    failovers: int = 0           # shard calls recovered on a sibling after failure
    last_degraded: bool = False  # the most recent response's degraded flag
    latency_window: int = 4096
    _latencies_s: Optional[deque] = field(default=None, repr=False)

    def __post_init__(self):
        self._latencies_s = deque(maxlen=self.latency_window)

    def record(self, seconds: float, candidates: int, requests: int = 1) -> None:
        self.requests += requests
        self.candidates += candidates
        self.seconds += seconds
        # every request in a microbatch completes when the batch does, so the
        # batch wall time is each request's latency; maxlen evicts the oldest
        self._latencies_s.extend([seconds] * requests)

    def merge(self, other: "ServeStats") -> None:
        """Fold another accumulator into this one: one merge per
        caller-visible batch, under the engine lock, however many spans the
        parallel pipeline scored (latency percentiles count requests, not
        spans)."""
        self.requests += other.requests
        self.candidates += other.candidates
        self.rows_scored += other.rows_scored
        self.seconds += other.seconds
        self.updates_applied += other.updates_applied
        self.update_bytes += other.update_bytes
        self.ctx_partials_full += other.ctx_partials_full
        self.ctx_tail_fields += other.ctx_tail_fields
        self.degraded_responses += other.degraded_responses
        self.deadline_misses += other.deadline_misses
        self.hedged_calls += other.hedged_calls
        self.failovers += other.failovers
        self.last_degraded = self.last_degraded or other.last_degraded
        self._latencies_s.extend(other._latencies_s)

    @property
    def dedup_saved(self) -> int:
        """Candidate rows the cross-request dedup avoided scoring."""
        return self.candidates - self.rows_scored

    @property
    def predictions_per_s(self) -> float:
        return self.candidates / max(self.seconds, 1e-9)

    def latency_ms(self, pct: float) -> float:
        snap = list(self._latencies_s)
        if not snap:
            return 0.0
        return float(np.percentile(np.asarray(snap), pct) * 1e3)

    @property
    def p50_ms(self) -> float:
        return self.latency_ms(50.0)

    @property
    def p95_ms(self) -> float:
        return self.latency_ms(95.0)

    @property
    def p99_ms(self) -> float:
        return self.latency_ms(99.0)


# ---------------------------------------------------------------------------
# Parallel scoring pool
# ---------------------------------------------------------------------------

def auto_parallel_workers(cpu_count: Optional[int] = None) -> int:
    """The policy of ``parallel=None``: 1 (off) on a single-core host,
    otherwise one worker per core capped at 4."""
    n = (os.cpu_count() if cpu_count is None else cpu_count) or 1
    return 1 if n < 2 else min(int(n), 4)


class ScoringPool:
    """Persistent worker pool + buffer recycler (one per engine, created on
    the first split batch; a ``ShardRouter`` builds its whole fleet around
    one shared pool).

    * :meth:`run` pipelines a burst's spans: *prepare* callables run on
      pool threads while the caller thread runs each *dispatch* in fixed
      span order, with a look-ahead of ``workers + 1`` spans.
    * :meth:`acquire` / :meth:`release` recycle buffers (a fleet's device
      buffers, a host-gather engine's pinned host blocks), at most two per
      worker per (shape, dtype, device, pinned or not). A buffer released
      with the CUDA event recorded after the last device work that touches
      it is handed out again only once that event has completed, so a
      kernel or an upload still in flight (a hedge loser's) never sees its
      buffer reused.
    * :meth:`submit` is the raw executor, the router's fan-out.
    """

    def __init__(self, workers: int):
        self.workers = max(1, int(workers))
        self._ex = ThreadPoolExecutor(max_workers=self.workers,
                                      thread_name_prefix="scoring-pool")
        self._buffers: Dict[tuple, list] = {}  # guarded-by: _buf_lock
        self._buf_lock = threading.Lock()
        # secondary failures discarded by run()'s drain (the first error
        # re-raises), latched so an aborted burst cannot hide them
        self.drain_errors = 0
        self.last_drain_error: Optional[BaseException] = None

    @staticmethod
    def _key(shape, dtype, device, pinned: bool) -> tuple:
        # pinned host buffers are kept apart from pageable ones
        return (shape, dtype, device) + (("pinned",) if pinned else ())

    def acquire(self, shape: tuple, dtype: torch.dtype,
                device=None, pin_memory: bool = False) -> torch.Tensor:
        """A recycled buffer of this shape, dtype and device, in pinned host
        memory when ``pin_memory`` (fresh if none is free). Waits on the
        event its last user released it with."""
        dev = torch.device("cpu" if device is None else device)
        key = self._key(tuple(shape), dtype, dev, pin_memory)
        with self._buf_lock:
            free = self._buffers.get(key)
            entry = free.pop() if free else None
        if entry is None:
            return torch.empty(shape, dtype=dtype, device=dev,
                               pin_memory=pin_memory)
        buf, event = entry
        if event is not None:
            event.synchronize()
        return buf

    def release(self, buf: torch.Tensor, event=None) -> None:
        """Return a buffer to the free list. ``event``: the CUDA event
        recorded after the last device work on ``buf`` (``None`` when no
        device work is pending on it). Extras beyond the double-buffer depth
        go back to the allocator."""
        key = self._key(tuple(buf.shape), buf.dtype, buf.device,
                        buf.device.type == "cpu" and buf.is_pinned())
        with self._buf_lock:
            free = self._buffers.setdefault(key, [])
            if len(free) < 2 * self.workers:
                free.append((buf, event))

    def submit(self, fn, *args):
        """Raw executor submit: the ShardRouter's scatter-gather fan-out."""
        return self._ex.submit(fn, *args)

    def run(self, prepares: Sequence, dispatch, cleanup=None) -> list:
        """Pipeline ``prepares`` (pool threads, bounded look-ahead) against
        ``dispatch`` (caller thread, fixed order); returns the dispatch
        results in prepare order.

        If a prepare or dispatch raises, the prepares still in flight are
        drained: each completed result goes to ``cleanup`` (which returns a
        span's host-gather buffer to the pool), errors are counted, and the
        first error re-raises, so an aborted burst leaves no future running
        into the next batch and strands no buffer."""
        window = self.workers + 1
        pending: deque = deque()
        out = []
        try:
            for prep in prepares:
                pending.append(self._ex.submit(prep))
                if len(pending) >= window:
                    out.append(dispatch(pending.popleft().result()))
            while pending:
                out.append(dispatch(pending.popleft().result()))
        except BaseException:
            while pending:
                try:
                    res = pending.popleft().result()
                except Exception as e:
                    # the first error already propagates; count the rest
                    self.drain_errors += 1
                    self.last_drain_error = e
                    continue
                if cleanup is not None:
                    try:
                        cleanup(res)
                    except Exception as e:
                        self.drain_errors += 1
                        self.last_drain_error = e
            raise
        return out

    def shutdown(self) -> None:
        self._ex.shutdown(wait=True)


# ---------------------------------------------------------------------------
# Scoring plan
# ---------------------------------------------------------------------------

BACKENDS = ("reference", "cuda")

# contexts recomputed per step of ``prewarm_contexts``
PREWARM_CHUNK = 8
# rows per call of the model head in the candidate forwards: the largest
# block warmup's default buckets emit (8 rows x 64 candidates)
HEAD_ROWS = 512


class ScoringPlan:
    """Request-independent scoring choices: the validated context/candidate
    field split, the power-of-two candidate padding buckets, the backend and
    whether buckets score through the fused kernels. Built once per
    engine."""

    def __init__(self, cfg: FFMConfig, model: str = "deepffm",
                 backend: str = "cuda", min_bucket: int = 8,
                 fused: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if not 1 <= cfg.context_fields < cfg.n_fields:
            raise ValueError("context cache needs 1 <= context_fields < n_fields")
        if fused and model != "ffm":
            # the fused kernel emits additive-head logits; MergeNorm/MLP heads
            # need the full pair vector and stay on the staged path
            raise ValueError(f"fused scoring requires model='ffm', got {model!r}")
        self.cfg, self.model, self.backend = cfg, model, backend
        self.fused = bool(fused)
        self.min_bucket = max(1, min_bucket)

    def bucket(self, n: int, minimum: Optional[int] = None) -> int:
        """Smallest power-of-two >= n (floored at ``min_bucket``)."""
        b = max(1, self.min_bucket if minimum is None else minimum)
        while b < n:
            b *= 2
        return b

    def buckets_upto(self, n: int, minimum: Optional[int] = None) -> List[int]:
        """All buckets the engine can emit for sizes in [1, n] — the closed
        shape set :meth:`InferenceEngine.warmup` runs."""
        out, b = [], self.bucket(1, minimum)
        top = self.bucket(n, minimum)
        while b <= top:
            out.append(b)
            b *= 2
        return out


# ---------------------------------------------------------------------------
# Scoring path
# ---------------------------------------------------------------------------

def compute_context(cfg: FFMConfig, params, ctx_idx: torch.Tensor,
                    ctx_val: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Context-only pass (§5). ctx_idx/val: (Fc,). Returns the cacheable
    partial in *prefix state* format (see ``ffm.extend_context_prefix``);
    any prefix depth of the state is a pure slice of it."""
    emb = params["ffm"]["emb"]
    prefix = ffm.empty_context_prefix(cfg, ffm.table_dtype(emb),
                                      ctx_idx.device)
    return ffm.extend_context_prefix(cfg, emb, params["lr"]["w"], prefix,
                                     ctx_idx, ctx_val)


def _reference_candidate_pairs(cfg: FFMConfig, emb_ctx, val_ctx, ec, cand_val):
    """ctx-cand / cand-cand pair columns from gathered f32 candidate rows —
    the plain math of the reference backend."""
    f0 = cfg.context_fields
    (pi, pj), _, xc, aa = ffm.on_device(ffm.pair_split, (cfg,), ec.device)
    # ctx-cand: pair (i ctx, j cand): dot(emb_ctx[i, j], ec[j-f0, i]) * v_i * v_j
    exi = emb_ctx[:, pi[xc], pj[xc]]                  # (R, n_xc, k) ctx side
    exj = ec[:, :, pj[xc] - f0, pi[xc]]               # (R, N, n_xc, k) cand side
    vx = val_ctx[:, pi[xc]][:, None, :] * cand_val[:, :, pj[xc] - f0]
    pairs_xc = torch.einsum("rxk,rnxk->rnx", exi, exj) * vx

    # cand-cand
    eai = ec[:, :, pi[aa] - f0, pj[aa]]               # (R, N, n_aa, k)
    eaj = ec[:, :, pj[aa] - f0, pi[aa]]
    va = cand_val[:, :, pi[aa] - f0] * cand_val[:, :, pj[aa] - f0]
    pairs_aa = torch.einsum("rnxk,rnxk->rnx", eai, eaj) * va
    return pairs_xc, pairs_aa


def _finish_candidates(cfg: FFMConfig, model: str, params, cached,
                       pairs_xc, pairs_aa, lr_cand):
    """Assemble the canonical pair vector and run the model head.
    ``lr_cand``: (R, N) candidate LR sums."""
    r, n = lr_cand.shape
    dev = lr_cand.device
    _, cc, xc, aa = ffm.on_device(ffm.pair_split, (cfg,), dev)
    perm = ffm.on_device(ffm.prefix_to_cc_perm, (cfg,), dev)
    pairs_cc = cached["pairs"][:, perm]
    lr_ctx = torch.sum(cached["lr_terms"], dim=-1)

    vec = torch.zeros((r, n, cfg.n_pairs), dtype=pairs_aa.dtype, device=dev)
    vec[:, :, cc] = pairs_cc[:, None, :].expand(r, n, cc.numel())
    vec[:, :, xc] = pairs_xc
    vec[:, :, aa] = pairs_aa

    lr_out = (lr_ctx[:, None] + lr_cand + params["lr"]["b"]).reshape(-1)
    vec = vec.reshape(r * n, cfg.n_pairs)
    # the head runs on tiles of exactly HEAD_ROWS rows, the last one
    # zero-padded: cuBLAS picks its GEMM kernel by the row count, so a row's
    # logit would otherwise depend on how many rows share its call, and the
    # span pipeline's splits (and the fleet's) would move scores
    pad = (-(r * n)) % HEAD_ROWS
    if pad:
        lr_out = torch.cat([lr_out, lr_out.new_zeros(pad)])
        vec = torch.cat([vec, vec.new_zeros((pad, cfg.n_pairs))])
    logits = torch.cat([
        deepffm.head_from_parts(cfg, params, lr_out[i:i + HEAD_ROWS],
                                vec[i:i + HEAD_ROWS], model)
        for i in range(0, lr_out.shape[0], HEAD_ROWS)])
    return logits[:r * n].reshape(r, n)


def batched_candidates_forward(cfg: FFMConfig, model: str, backend: str,
                               params, cached, cand_idx: torch.Tensor,
                               cand_val: torch.Tensor) -> torch.Tensor:
    """Candidate completion for a stack of R request rows.

    ``cached`` leaves carry a leading row axis R (stacked prefix states from
    :func:`compute_context`); cand_idx/val: (R, N, F-Fc). Returns logits
    (R, N). With ``backend == "cuda"`` the pair columns come from the
    candidate kernels: an int8 table's codes are gathered as they are and
    dequantized inside the kernel."""
    emb = params["ffm"]["emb"]
    emb_ctx, val_ctx = cached["emb"], cached["val"]

    if backend == "cuda":
        from repro_torch.kernels.ffm_interaction import ops as ffm_ops

        if isinstance(emb, dict):  # int8 rows: gather codes, dequant in-kernel
            qc = emb["codes"][cand_idx]
            s = emb["scale"][cand_idx]
            z = emb["zero"][cand_idx]
            pairs_xc, pairs_aa = ffm_ops.candidate_interactions_q8(
                cfg, emb_ctx, val_ctx, qc, s, z, cand_val)
        else:
            ec = emb[cand_idx]  # (R, N, Fcand, F, k)
            pairs_xc, pairs_aa = ffm_ops.candidate_interactions(
                cfg, emb_ctx, val_ctx, ec, cand_val)
    else:
        # gather_rows dequantizes right after the gather when emb is int8
        ec = ffm.gather_rows(emb, cand_idx)               # (R, N, Fcand, F, k)
        pairs_xc, pairs_aa = _reference_candidate_pairs(
            cfg, emb_ctx, val_ctx, ec, cand_val)

    lr_cand = torch.sum(ffm.gather_lr(params["lr"]["w"], cand_idx) * cand_val,
                        dim=-1)
    return _finish_candidates(cfg, model, params, cached,
                              pairs_xc, pairs_aa, lr_cand)


def batched_candidates_forward_q8(cfg: FFMConfig, model: str, backend: str,
                                  head_params, cached, qc, scale, zero,
                                  cand_val, lr_terms) -> torch.Tensor:
    """Candidate completion over *pre-gathered* int8 candidate codes (the
    host pre-gather's forward): ``qc`` (R, N, Fcand, F, k) int8 codes,
    ``scale``/``zero`` (R, N, Fcand) their grids, ``lr_terms`` (R, N,
    Fcand) the candidates' LR weights times their values. The JAX forward
    takes their host sum; here they are summed on the device by the same
    reduction :func:`batched_candidates_forward` runs, so a host-gather
    engine scores bit for bit as its device-gather twin. ``head_params``
    holds only the head's leaves (LR bias, MergeNorm, MLP:
    :meth:`InferenceEngine._head_params`); no table is read here. Returns
    logits (R, N)."""
    emb_ctx, val_ctx = cached["emb"], cached["val"]
    if backend == "cuda":
        from repro_torch.kernels.ffm_interaction import ops as ffm_ops

        pairs_xc, pairs_aa = ffm_ops.candidate_interactions_q8(
            cfg, emb_ctx, val_ctx, qc, scale, zero, cand_val)
    else:
        ec = (qc.to(torch.float32) * scale[..., None, None]
              + zero[..., None, None])
        pairs_xc, pairs_aa = _reference_candidate_pairs(
            cfg, emb_ctx, val_ctx, ec, cand_val)
    return _finish_candidates(cfg, model, head_params, cached,
                              pairs_xc, pairs_aa,
                              torch.sum(lr_terms, dim=-1))


def batched_candidates_forward_rows(cfg: FFMConfig, model: str, backend: str,
                                    head_params, cached, ec, cand_val,
                                    lr_terms) -> torch.Tensor:
    """f32 twin of :func:`batched_candidates_forward_q8`: pre-gathered f32
    candidate rows ``ec`` (R, N, Fcand, F, k) instead of codes and grids."""
    emb_ctx, val_ctx = cached["emb"], cached["val"]
    if backend == "cuda":
        from repro_torch.kernels.ffm_interaction import ops as ffm_ops

        pairs_xc, pairs_aa = ffm_ops.candidate_interactions(
            cfg, emb_ctx, val_ctx, ec, cand_val)
    else:
        pairs_xc, pairs_aa = _reference_candidate_pairs(
            cfg, emb_ctx, val_ctx, ec, cand_val)
    return _finish_candidates(cfg, model, head_params, cached,
                              pairs_xc, pairs_aa,
                              torch.sum(lr_terms, dim=-1))


def _fused_base(cached, lr_terms, lr_b):
    """(R, N) logit terms the fused kernels add to the pairs they compute:
    context LR + the cached prefix's pair sum + candidate LR + bias."""
    return ((torch.sum(cached["lr_terms"], dim=-1)
             + cached["pair_sum"])[:, None] + torch.sum(lr_terms, dim=-1)
            + lr_b)


def fused_candidates_forward_q8(cfg: FFMConfig, lr_b, cached, qc, scale, zero,
                                cand_val, lr_terms):
    """One fused kernel launch per padding bucket over gathered int8
    candidate codes (``"ffm"`` model only: the head is the additive LR +
    pair sum).

    ``cached`` is the stacked *fused* context state: ``emb`` (R, Fc, F, k)
    full-depth embeddings, ``val`` (R, Fc), ``depth`` (R,) cached prefix
    depths, ``pair_sum`` (R,) summed cached ctx pairs, ``lr_terms`` (R, Fc).
    ``qc`` (R, N, Fcand, F, k) codes with grids ``scale``/``zero``
    (R, N, Fcand), ``lr_terms`` (R, N, Fcand) the candidates' LR weights
    times their values (summed here, as :func:`batched_candidates_forward_q8`
    sums them). Returns
    ``(logits (R, N), ctx_dots (R, Fc, Fc))``; the second output rebuilds
    insertable prefix states (``ffm.prefix_state_from_dots``)."""
    from repro_torch.kernels.ffm_interaction import ops as ffm_ops

    return ffm_ops.fused_candidate_logits_q8(
        cfg, cached["emb"], cached["val"], cached["depth"],
        _fused_base(cached, lr_terms, lr_b), qc, scale, zero, cand_val)


def fused_candidates_forward_rows(cfg: FFMConfig, lr_b, cached, ec, cand_val,
                                  lr_terms):
    """f32 twin of :func:`fused_candidates_forward_q8` (gathered f32 rows
    ``ec`` (R, N, Fcand, F, k) instead of codes and grids)."""
    from repro_torch.kernels.ffm_interaction import ops as ffm_ops

    return ffm_ops.fused_candidate_logits_rows(
        cfg, cached["emb"], cached["val"], cached["depth"],
        _fused_base(cached, lr_terms, lr_b), ec, cand_val)


def fused_candidates_forward(cfg: FFMConfig, params, cached,
                             cand_idx: torch.Tensor, cand_val: torch.Tensor):
    """The fused forward of an engine that gathers on the device: the
    candidate codes and grids (int8) or rows (f32) and the LR terms are
    gathered by indexing, then one fused kernel launch scores the bucket
    (:func:`fused_candidates_forward_q8` / ``_rows``). Returns ``(logits
    (R, N), ctx_dots (R, Fc, Fc))``."""
    emb = params["ffm"]["emb"]
    lr_terms = ffm.gather_lr(params["lr"]["w"], cand_idx) * cand_val
    lr_b = params["lr"]["b"]
    if isinstance(emb, dict):  # int8 rows: codes + grids, no dequant
        return fused_candidates_forward_q8(
            cfg, lr_b, cached, emb["codes"][cand_idx], emb["scale"][cand_idx],
            emb["zero"][cand_idx], cand_val, lr_terms)
    return fused_candidates_forward_rows(cfg, lr_b, cached, emb[cand_idx],
                                         cand_val, lr_terms)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class InferenceEngine:
    """Scoring path of the serving stack: prefix-sharing context cache x
    cross-request candidate dedup x candidate kernels x bucketed request
    batching, on one device.

    * ``device`` — ``None`` means the card; pass ``"cpu"`` to run the plain
      versions of the kernels (the tests do).
    * ``backend`` — ``"cuda"`` (default) scores candidates through the
      kernels; ``"reference"`` is the plain-tensor oracle path.
    * ``prefix_stride`` / ``prefix_depths`` — checkpoint depths of the
      prefix cache (``None`` stride: full-depth entries only).
    * ``dedup`` — score each unique ``(context, candidate)`` row once per
      microbatch and scatter results back per request.
    * ``warmup_buckets`` — ``(max_requests, max_candidates)``; when given
      (and params are installed) :meth:`warmup` runs at construction.
    * ``quantized`` — serve from int8 tables: installed f32 params are
      quantized on the host (bit-identical to the JAX package's tables) and
      moved to the device.
    * ``host_gather`` — gather candidate codes / rows, grids and LR terms
      on the host and score the uploaded blocks
      (:func:`batched_candidates_forward_q8` / ``_rows``, or the fused
      forwards); see the module docstring. ``None`` (default) takes it where
      ``row_gather.ops.use_host_gather`` says: on a CPU device past the
      gather cliff (calibrated once per process, ``REPRO_CLIFF_CALIBRATE=0``
      pins the constant), never on the card.
    * ``fused`` — score each padding bucket in one fused kernel launch
      (:func:`fused_candidates_forward_q8` / ``_rows``; ``"ffm"`` model
      only, whatever ``backend``). ``None`` (default) fuses exactly where the
      JAX engine does: a quantized ``"ffm"`` engine whose ``host_gather``
      was *auto*-picked true; so on the card it means staged. Unlike the
      JAX engine's, ``fused=True`` does not force ``host_gather`` on: fused
      engines gather on the device unless asked (ROADMAP.md Queue 3).
    * ``parallel`` — worker count of the span pipeline (module docstring);
      ``None`` resolves through :func:`auto_parallel_workers`. The default
      is 1 (the JAX engine's auto default overlaps a host pre-gather that
      this engine takes only when asked or on a CPU device past the cliff).
      ``scoring_pool`` injects a shared :class:`ScoringPool` (the
      ShardRouter's).
    """

    def __init__(self, cfg: FFMConfig, model: str = "deepffm", *,
                 backend: str = "cuda", params=None,
                 device: DeviceLike = None,
                 cache_entries: int = 4096, min_bucket: int = 8,
                 prefix_stride: Optional[int] = 4, dedup: bool = True,
                 warmup_buckets: Optional[Tuple[int, int]] = None,
                 quantized: bool = False,
                 prefix_depths: Optional[Sequence[int]] = None,
                 host_gather: Optional[bool] = None,
                 fused: Optional[bool] = None,
                 parallel: Optional[int] = 1,
                 scoring_pool: Optional[ScoringPool] = None):
        from repro_torch.kernels.row_gather import ops as rg_ops

        self.device = resolve_device(device)
        host_auto = host_gather is None
        resolved_host = (rg_ops.use_host_gather(cfg.hash_space, self.device)
                         if host_auto else bool(host_gather))
        if fused is None:
            fused = (model == "ffm" and quantized and resolved_host
                     and host_auto)
        self.plan = ScoringPlan(cfg, model, backend=backend,
                                min_bucket=min_bucket, fused=bool(fused))
        self.cache_entries = cache_entries
        self.dedup = dedup
        self.quantized = quantized
        self.host_gather = resolved_host
        # the host mirror's builds and the last build's milliseconds
        # (:meth:`_host_weights`)
        self.host_mirror_builds = 0
        self.host_mirror_ms = 0.0
        self._weights: Tuple[Optional[Dict], int] = (  # guarded-by: _lock
            self._maybe_quantize(params), 0)
        self._cache = PrefixCache(  # guarded-by(calls): _lock
            cfg.context_fields, cache_entries,
            stride=prefix_stride, depths=prefix_depths)
        self._lock = threading.Lock()  # cache structure + counters + weights
        self.hits = 0    # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.stats = ServeStats()  # guarded-by: _lock
        self.weights_version = 0  # trainer's stamp from the update frame
        self.parallel = (auto_parallel_workers() if parallel is None
                         else max(1, int(parallel)))
        self._scoring_pool = scoring_pool  # guarded-by: _lock
        self._owns_pool = scoring_pool is None
        self._pipe: Optional[UpdatePipe] = None  # guarded-by: _pipe_lock
        self._pipe_lock = threading.Lock()
        # score_batch(deadline_ms=)'s absolute time.monotonic() budget,
        # per thread: concurrent scorers carry their own budgets
        self._deadline_tl = threading.local()
        if warmup_buckets is not None and params is not None:
            self.warmup(max_requests=warmup_buckets[0],
                        max_candidates=warmup_buckets[1])

    # -- configuration passthroughs ----------------------------------------
    @property
    def cfg(self) -> FFMConfig:
        return self.plan.cfg

    @property
    def model(self) -> str:
        return self.plan.model

    @property
    def backend(self) -> str:
        return self.plan.backend

    @property
    def fused(self) -> bool:
        return self.plan.fused

    @property
    def params(self):
        return self._weights[0]

    @property
    def generation(self) -> int:
        return self._weights[1]

    @property
    def cache_hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def prefix_hit_depths(self) -> Counter:
        """Histogram of cached-prefix depth matched per context lookup
        (depth == context_fields is a full hit, 0 a cold miss)."""
        return self._cache.hit_depths

    @property
    def resident_weight_bytes(self) -> int:
        """Device bytes of the published weight tree — ~4x smaller with
        ``quantized=True`` (emb: int8 codes + two f32 scalars per row; LR:
        int8 codes + two f32 scalars per block)."""
        def nbytes(node):
            if isinstance(node, dict):
                return sum(nbytes(v) for v in node.values())
            if isinstance(node, torch.Tensor):
                return node.numel() * node.element_size()
            return 0

        return nbytes(self.params)

    def suggest_checkpoint_depths(self, max_depths: int = 4,
                                  min_share: float = 0.05) -> List[int]:
        """Checkpoint depths adapted to observed traffic: the intermediate
        depths of :attr:`prefix_hit_depths` carrying at least ``min_share``
        of the intermediate hits (at most ``max_depths`` of them), plus the
        full depth. The current set when no intermediate depth was reused.
        Feed it to a new engine's ``prefix_depths`` (:meth:`rotate`)."""
        fc = self.cfg.context_fields
        with self._lock:  # scorer threads insert histogram keys under it
            hist = dict(self._cache.hit_depths)
            current = self._cache.checkpoint_depths()
        inter = {d: c for d, c in hist.items() if 0 < d < fc and c > 0}
        total = sum(inter.values())
        if not total:
            return current
        ranked = sorted(inter.items(), key=lambda dc: (-dc[1], dc[0]))
        keep = [d for d, c in ranked if c / total >= min_share][:max_depths]
        return sorted(set(keep) | {fc})

    # -- weight management (§3 / §6) ---------------------------------------
    def _maybe_quantize(self, params, prev=None, touched_rows=None):
        """Move ``params`` to the engine's device and, on a quantized engine,
        replace the f32 gather tables with int8 tables (a no-op for tables
        that are already quantized; ``prev`` / ``touched_rows`` requantize
        only touched rows, see ``quantization.quantize_params_rows``)."""
        if params is None:
            return None
        params = to_device(params, self.device)
        if not self.quantized:
            return params
        return Q.quantize_params_rows(params, prev=prev,
                                      touched_rows=touched_rows)

    def install_params(self, params) -> None:
        """Swap the weight tree in place. The (params, generation) pair is
        published atomically, so concurrent scorers see either the old or
        the new version, never a mix."""
        params = self._maybe_quantize(params)
        with self._lock:  # serialize the generation bump against _publish
            self._weights = (params, self._weights[1] + 1)

    def _publish(self, params, version: int, nbytes: int) -> int:
        """Atomically install a fully materialized params tree (the update
        pipe's publish step — the only weight work under the request lock).
        The quantize fallback runs *before* the lock and is a no-op for the
        update pipe, which ships already-quantized tables; a host-gather
        engine builds the new tables' host mirror there too."""
        params = self._maybe_quantize(params)
        if self.host_gather:
            self._host_weights(params)
        with self._lock:
            self._weights = (params, self._weights[1] + 1)
            self.weights_version = version
            self.stats.updates_applied += 1
            self.stats.update_bytes += nbytes
            return self._weights[1]

    def update_pipe(self, manifest=None, like_params=None) -> UpdatePipe:
        """The engine's (lazily created) trainer-update ingestion pipe."""
        with self._pipe_lock:
            pipe, created = self._pipe, False
            if pipe is None:
                pipe = self._pipe = UpdatePipe(self, manifest=manifest,
                                               like_params=like_params)
                created = True
        # reconfigure outside _pipe_lock: configure serializes behind the
        # pipe's _ingest_lock, which ranks *below* _pipe_lock in the
        # declared lock order
        if not created and (manifest is not None or like_params is not None):
            pipe.configure(manifest, like_params)
        return pipe

    def apply_update(self, update: bytes, manifest=None, like_params=None) -> None:
        """Ingest one trainer update (full file, patch, or row delta) and
        hot-swap weights — a thin synchronous wrapper over the update pipe.

        Cache-preserving: the prefix tree keeps its entries; lookups compare
        each entry's generation stamp and recompute stale partials. Decode,
        dequantize and requantize happen *outside* the request lock (on the
        pipe's own stream on the card); only the final (params, generation)
        pointer swap takes it.
        """
        self.update_pipe().ingest(update, manifest=manifest,
                                  like_params=like_params)

    def submit_update(self, update: bytes, manifest=None,
                      like_params=None) -> bool:
        """Asynchronous :meth:`apply_update`: enqueue the frame for the update
        pipe's background thread and return once it is queued — *not* once it
        is applied. A full pipe queue applies backpressure (blocks the caller
        until a slot frees) rather than dropping, because dropped frames
        would desync the Sender's patch/delta chain. The new generation
        becomes visible to scorers at the pipe's publish; ``update_pipe().
        flush()`` waits for it."""
        pipe = self.update_pipe(manifest, like_params)
        return pipe.submit(update, block=True)

    def prewarm_contexts(self, params=None, generation: Optional[int] = None,
                         pause_s: float = 0.0) -> int:
        """Recompute every cached context partial against ``(params,
        generation)`` — by default the *next* generation — and install the
        results, ``PREWARM_CHUNK`` contexts at a time.

        The update pipe calls this from its ingest thread with the freshly
        decoded standby params *before* publishing them: the atomic swap then
        flips both the weights and an already-warm cache, so post-swap
        requests get full-depth hits instead of paying the stale recompute on
        the request path. Cache nodes hold per-generation entry slots (two
        newest), so current-generation scorers keep their hits while the next
        generation warms. ``pause_s`` sleeps between chunks (cooperative
        throttling on the ingest thread). Returns the number of contexts
        recomputed."""
        if params is None:
            params = self.params
        if params is None:
            return 0
        if generation is None:
            generation = self.generation + 1
        with self._lock:
            keys = self._cache.keys()
        ctxs = [(key, *context_from_tokens(key)) for key in keys]
        for i in range(0, len(ctxs), PREWARM_CHUNK):
            # record_stats=False: prewarm churn must not pollute the
            # request-path hit-depth histogram or partial/tail counters
            self._resolve_contexts(ctxs[i:i + PREWARM_CHUNK], params,
                                   generation, record_stats=False)
            if pause_s:
                time.sleep(pause_s)
        return len(ctxs)

    # -- host mirror of the gather tables (the host pre-gather) --------------
    _host_tables: Tuple = ()  # up to 2 of (params, emb_view, lr_view)

    def _host_weights(self, params):
        """Host numpy views of the gather tables (emb, LR) for the host
        pre-gather, cached per params object. On a CPU device they are
        zero-copy views; on the card, a device-to-host copy into pinned host
        memory, timed (:attr:`host_mirror_ms`, :attr:`host_mirror_builds`).
        Two slots, as in the JAX engine: the published generation and the
        standby one. A benign race: concurrent fills build the same views."""
        for entry in self._host_tables:
            if entry[0] is params:
                return entry[1], entry[2]

        def host_view(t):
            if isinstance(t, dict):
                return {k: host_view(v) for k, v in t.items()}
            if not isinstance(t, torch.Tensor):  # the LR block size
                return t
            if t.device.type == "cpu":
                return t.numpy()
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t).numpy()

        t0 = time.perf_counter()
        emb = host_view(params["ffm"]["emb"])
        lr = host_view(params["lr"]["w"])
        self.host_mirror_ms = (time.perf_counter() - t0) * 1e3
        self.host_mirror_builds += 1
        self._host_tables = ((params, emb, lr),) + self._host_tables[:1]
        return emb, lr

    def _head_params(self, params):
        """``params`` without the gather tables: what the pre-gathered
        forwards read (LR bias, MergeNorm, MLP)."""
        out = {k: v for k, v in params.items() if k != "ffm"}
        out["lr"] = {"b": params["lr"]["b"]}
        return out

    # -- context cache (§5, prefix tree) ------------------------------------
    def _context_tensors(self, ctxs) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (idx, val) rows of every context of a burst on the device,
        uploaded together once the first miss needs them."""
        idx = np.stack([c[1] for c in ctxs])
        val = np.stack([c[2] for c in ctxs])
        return (torch.from_numpy(idx).to(self.device),
                torch.from_numpy(val).to(self.device))

    def _resolve_contexts(self, ctxs: List[Tuple[Tuple[bytes, ...],
                                                 np.ndarray, np.ndarray]],
                          params, generation: int,
                          record_stats: bool = True
                          ) -> Tuple[List[Dict], List[bool]]:
        """Full-depth prefix states for each unique (tokens, idx, val)
        context, plus a full-depth-hit flag per context (``record_stats``:
        count the lookups in the hit-depth histogram and the counters).

        Prefix-tree lookups find the deepest cached partial per context; the
        remaining tails are computed on the device per miss group, one group
        per distinct cached depth. Resolution runs in rounds so prefix
        sharing works *within* a miss burst too: when several uncached
        contexts share a checkpoint prefix, one representative per distinct
        prefix is computed (and inserted) first, and the rest re-look-up in
        the next round to reuse it.
        """
        fc = self.cfg.context_fields
        with self._lock:
            checkpoints = [d for d in self._cache.checkpoint_depths()
                           if d < fc]
        states: List[Optional[Dict]] = [None] * len(ctxs)
        full_hit: List[bool] = [False] * len(ctxs)
        emb, lr_w = params["ffm"]["emb"], params["lr"]["w"]
        empty = ffm.empty_context_prefix(self.cfg, ffm.table_dtype(emb),
                                         self.device)
        ctx_idx = ctx_val = None  # uploaded once, on the first miss

        pending = list(range(len(ctxs)))
        first_round = True
        while pending:
            with self._lock:
                looked = {i: self._cache.lookup(ctxs[i][0], generation)
                          for i in pending}
            claimed: set = set()
            miss_groups: Dict[int, List[int]] = {}
            deferred: List[int] = []
            for i in pending:
                depth, state = looked[i]
                if depth == fc:
                    # only possible in the first round: contexts are unique
                    # within a burst, so later rounds never find a full match
                    states[i] = state
                    full_hit[i] = first_round
                    if record_stats:
                        with self._lock:
                            self._cache.hit_depths[fc] += 1
                    continue
                above = [(d, ctxs[i][0][:d]) for d in checkpoints if d > depth]
                if any(c in claimed for c in above):
                    deferred.append(i)  # another context computes this prefix
                else:
                    claimed.update(above)
                    miss_groups.setdefault(depth, []).append(i)
            first_round = False

            if miss_groups and ctx_idx is None:
                ctx_idx, ctx_val = self._context_tensors(ctxs)
            for depth, members in sorted(miss_groups.items()):
                t = fc - depth
                fresh = []
                for i in members:
                    base = (ffm.slice_context_prefix(looked[i][1], depth)
                            if looked[i][1] is not None else empty)
                    fresh.append(ffm.extend_context_prefix(
                        self.cfg, emb, lr_w, base,
                        ctx_idx[i, depth:], ctx_val[i, depth:]))
                with self._lock:
                    if record_stats:
                        self.stats.ctx_partials_full += sum(
                            1 for i in members if looked[i][0] == 0)
                        self.stats.ctx_tail_fields += t * len(members)
                    for i, state in zip(members, fresh):
                        if record_stats:
                            self._cache.hit_depths[depth] += 1
                        states[i] = state
                        self._cache.insert(ctxs[i][0], generation, state)
            pending = deferred
        return states, full_hit

    def _resolve_contexts_fused(self, ctxs: List[Tuple[Tuple[bytes, ...],
                                                       np.ndarray, np.ndarray]],
                                params, generation: int):
        """Gather-only context resolution for the fused scoring path.

        Returns ``(states, insert_info, full_hit)``: per context a stackable
        fused state (``ffm.fused_context_state`` — full-depth rows + LR terms
        + cached depth and pair sum, no pair arithmetic), plus for each
        cache miss the ``(depth, prefix_pairs)`` needed to rebuild and
        insert the full-depth state once the kernel has returned its ctx
        pair matrix (:meth:`_insert_fused_misses`).

        Unlike the staged resolver this runs a single round: the tail pairs
        do not exist until the fused kernel runs, so contexts in one burst
        cannot chain off each other's fresh inserts — each extends from its
        deepest *already-cached* prefix. The cache still learns (inserts
        land after scoring).
        """
        fc = self.cfg.context_fields
        states: List[Optional[Dict]] = [None] * len(ctxs)
        insert_info: List[Optional[Tuple]] = [None] * len(ctxs)
        full_hit: List[bool] = [False] * len(ctxs)
        with self._lock:
            looked = [self._cache.lookup(c[0], generation) for c in ctxs]
        emb, lr_w = params["ffm"]["emb"], params["lr"]["w"]
        empty = ffm.empty_context_prefix(self.cfg, ffm.table_dtype(emb),
                                         self.device)
        ctx_idx = ctx_val = None  # uploaded once, on the first miss
        n_full = tails = 0
        for i, (depth, state) in enumerate(looked):
            if depth == fc:
                full_hit[i] = True
                states[i] = {
                    "emb": state["emb"], "val": state["val"], "depth": fc,
                    "pair_sum": torch.sum(state["pairs"]),
                    "lr_terms": state["lr_terms"],
                }
                continue
            if ctx_idx is None:
                ctx_idx, ctx_val = self._context_tensors(ctxs)
            base = (ffm.slice_context_prefix(state, depth)
                    if state is not None else empty)
            states[i] = ffm.fused_context_state(
                self.cfg, emb, lr_w, base, ctx_idx[i, depth:],
                ctx_val[i, depth:])
            # a view, not a copy: cached states are never written in place
            insert_info[i] = (depth, base["pairs"])
            n_full += depth == 0
            tails += fc - depth
        with self._lock:
            for (depth, _), info in zip(looked, insert_info):
                self._cache.hit_depths[fc if info is None else depth] += 1
            self.stats.ctx_partials_full += n_full
            self.stats.ctx_tail_fields += tails
        return states, insert_info, full_hit

    def _insert_fused_misses(self, u_ctxs, states, insert_info, chunk_group,
                             u_of_group, ctx_dots: torch.Tensor,
                             generation: int) -> None:
        """Post-scoring cache insertion for the fused path: rebuild each
        missed context's full-depth prefix state from the kernel's ctx pair
        matrix (of the first chunk of its group) and insert it.
        ``chunk_group`` maps forward rows to groups; on a no-dedup engine
        ``u_of_group`` maps groups back to unique contexts. A context whose
        requests all carried empty slates never entered the forward and
        stays uninserted (no pair matrix to read back)."""
        if all(info is None for info in insert_info):
            return
        first_chunk: Dict[int, int] = {}
        for c, g in enumerate(chunk_group):
            u = int(g) if self.dedup else int(u_of_group[g])
            first_chunk.setdefault(u, c)
        inserts = []
        for u, info in enumerate(insert_info):
            if info is None or u not in first_chunk:
                continue
            inserts.append((u, ffm.prefix_state_from_dots(
                self.cfg, states[u], info[1], ctx_dots[first_chunk[u]])))
        with self._lock:
            for u, full in inserts:
                self._cache.insert(u_ctxs[u][0], generation, full)

    # -- scoring ------------------------------------------------------------
    def _require_params(self):
        if self.params is None:
            raise RuntimeError("no weights yet — install_params first")

    def _check_indices(self, *arrays: np.ndarray) -> None:
        """Feature indices arrive from outside the program; an out-of-range
        one would fault a gather on the card, so refuse it on the host."""
        v = self.cfg.hash_space
        for a in arrays:
            if a.size and (a.min() < 0 or a.max() >= v):
                raise ValueError(f"feature index out of range [0, {v})")

    def score(self, ctx_idx, ctx_val, cand_idx, cand_val, *,
              deadline_ms: Optional[float] = None) -> np.ndarray:
        """Score one request's candidates against its context. Returns logits (N,)."""
        return self.score_batch([(ctx_idx, ctx_val, cand_idx, cand_val)],
                                deadline_ms=deadline_ms)[0]

    def _deadline(self) -> Optional[float]:
        """This thread's in-flight ``time.monotonic()`` budget (``None``:
        unbounded), read by the ShardRouter's scatter-gather waits."""
        return getattr(self._deadline_tl, "until", None)

    def score_batch(self, requests: Sequence[Tuple], *,
                    deadline_ms: Optional[float] = None) -> List[np.ndarray]:
        """Microbatch several (ctx_idx, ctx_val, cand_idx, cand_val) requests.

        Contexts are resolved through the prefix cache; identical
        ``(context, candidate)`` rows across the microbatch are scored once
        and scattered back (``dedup=True``). The scored rows are padded to
        one power-of-two candidate bucket and power-of-two row spans, so
        every forward runs over a closed set of shapes. Scores are computed
        against exactly one atomically published (params, generation)
        snapshot.

        ``deadline_ms`` attaches a wall-clock budget to this batch: a plain
        engine's forward always runs to completion, a fan-out engine
        (ShardRouter) bounds its scatter-gather waits by it and zero-fills
        the slices that cannot answer in time, flagging the response.
        """
        if deadline_ms is None:
            return self._score_batch(requests)
        self._deadline_tl.until = time.monotonic() + deadline_ms / 1e3
        try:
            return self._score_batch(requests)
        finally:
            self._deadline_tl.until = None

    def _score_batch(self, requests: Sequence[Tuple]) -> List[np.ndarray]:
        self._require_params()
        if not requests:
            return []
        t0 = time.perf_counter()
        params, generation = self._weights

        fcand = self.cfg.n_fields - self.cfg.context_fields

        def slate(a, dtype):
            # normalize empty slates (any shape) to (0, Fcand) so empty and
            # non-empty requests concatenate in one microbatch; anything
            # non-empty must already be (N, Fcand)
            a = np.asarray(a, dtype)
            if a.size == 0:
                return a.reshape(0, fcand)
            if a.ndim != 2 or a.shape[1] != fcand:
                raise ValueError(
                    f"candidate slate must be (N, {fcand}), got {a.shape}")
            return a

        reqs = [(np.asarray(ci, np.int32), np.asarray(cv, np.float32),
                 slate(ki, np.int32), slate(kv, np.float32))
                for ci, cv, ki, kv in requests]
        fc = self.cfg.context_fields
        for ci, cv, ki, _ in reqs:
            if ci.shape != (fc,) or cv.shape != (fc,):
                raise ValueError(f"context must be ({fc},), got {ci.shape}")
            self._check_indices(ci, ki)

        # unique contexts across the microbatch
        u_of: List[int] = []
        u_index: Dict[Tuple[bytes, ...], int] = {}
        u_ctxs: List[Tuple[Tuple[bytes, ...], np.ndarray, np.ndarray]] = []
        for ci, cv, ki, kv in reqs:
            toks = context_tokens(ci, cv)
            u = u_index.get(toks)
            if u is None:
                u = u_index[toks] = len(u_ctxs)
                u_ctxs.append((toks, ci, cv))
            u_of.append(u)

        if self.fused:
            states, insert_info, full_hit = self._resolve_contexts_fused(
                u_ctxs, params, generation)
        else:
            states, full_hit = self._resolve_contexts(u_ctxs, params,
                                                      generation)
        # hit/miss bookkeeping matches the flat cache: first request of an
        # uncached context is the miss, every other request this batch (and
        # every full-depth match) is a hit
        seen_full = dict(enumerate(full_hit))
        with self._lock:
            for u in u_of:
                if seen_full[u]:
                    self.hits += 1
                else:
                    self.misses += 1
                    seen_full[u] = True

        # candidate rows: dedup identical (context, candidate) pairs across
        # requests, or keep one row-group per request
        if self.dedup:
            group_of_req = u_of
            n_groups = len(u_ctxs)
            group_state = states
        else:
            group_of_req = list(range(len(reqs)))
            n_groups = len(reqs)
            group_state = [states[u] for u in u_of]
        counts = np.asarray([r[2].shape[0] for r in reqs], np.int64)
        total = int(counts.sum())
        if total == 0:  # every request carried an empty slate
            with self._lock:
                self.stats.record(time.perf_counter() - t0, 0,
                                  requests=len(reqs))
            return [np.zeros((0,), np.float32) for _ in reqs]
        group_of_row = np.repeat(np.asarray(group_of_req, np.int64), counts)
        ki_all = np.concatenate([r[2] for r in reqs])      # (total, Fcand)
        kv_all = np.concatenate([r[3] for r in reqs])
        if self.dedup:
            # packed-array dedup: one contiguous (group | idx | val-bits)
            # int32 matrix viewed as void rows for np.unique
            mat = np.empty((total, 1 + 2 * fcand), np.int32)
            mat[:, 0] = group_of_row
            mat[:, 1:1 + fcand] = ki_all
            mat[:, 1 + fcand:] = kv_all.view(np.int32)
            packed = np.ascontiguousarray(mat).view(
                np.dtype((np.void, mat.itemsize * mat.shape[1])))[:, 0]
            _, first, inverse = np.unique(packed, return_index=True,
                                          return_inverse=True)
        else:
            first = inverse = np.arange(total)
        u_group = group_of_row[first]
        n_rows = int(first.size)

        # a dedup group unions candidates from several requests and can exceed
        # the per-request bucket; chunk groups to the request-level bucket so
        # padded work never exceeds the no-dedup layout and the shape set
        # stays the closed per-request one (see warmup)
        nb = self.plan.bucket(int(counts.max()))
        order = np.argsort(u_group, kind="stable")
        gcounts = np.bincount(u_group, minlength=n_groups)
        gstarts = np.concatenate([[0], np.cumsum(gcounts)[:-1]])
        pos = np.empty(n_rows, np.int64)  # rank of each unique row in its group
        pos[order] = np.arange(n_rows) - np.repeat(gstarts, gcounts)
        chunks_per_g = -(-gcounts // nb)
        chunk_base = np.concatenate([[0], np.cumsum(chunks_per_g)[:-1]])
        n_chunks = int(chunks_per_g.sum())
        row_of_u = chunk_base[u_group] + pos // nb
        slot_of_u = pos % nb

        # unpadded (n_chunks, nb, Fcand) candidate blocks; the span scorer
        # pads each contiguous chunk span to its own power-of-two row bucket
        # (padded rows and slots are inert: their outputs are never read)
        ki_c = np.zeros((n_chunks, nb, fcand), np.int32)
        kv_c = np.zeros((n_chunks, nb, fcand), np.float32)
        ki_c[row_of_u, slot_of_u] = ki_all[first]
        kv_c[row_of_u, slot_of_u] = kv_all[first]
        grids_c = self._compact_grids(params, ki_all[first], row_of_u,
                                      slot_of_u, n_chunks, nb, fcand)
        chunk_group = np.repeat(np.arange(n_groups), chunks_per_g)
        chunk_state = [group_state[g] for g in chunk_group]
        out, ctx_dots = self._score_spans(params, chunk_state, ki_c, kv_c,
                                          grids_c, self._plan_spans(n_chunks))
        if self.fused:
            self._insert_fused_misses(u_ctxs, states, insert_info,
                                      chunk_group, u_of, ctx_dots, generation)
        # plain numpy scatter-back
        flat = out[row_of_u[inverse], slot_of_u[inverse]]
        offs = np.concatenate([[0], np.cumsum(counts)])
        results = [flat[offs[i]:offs[i + 1]] for i in range(len(reqs))]
        batch_stats = ServeStats()
        batch_stats.rows_scored = n_rows
        batch_stats.record(time.perf_counter() - t0, total, requests=len(reqs))
        with self._lock:
            self.stats.merge(batch_stats)
        return results

    # -- parallel scoring pipeline ------------------------------------------
    def _get_pool(self) -> ScoringPool:
        """The engine's scoring pool: created on the first split batch, or
        the shared one injected through ``scoring_pool=``."""
        if self._scoring_pool is None:
            with self._lock:
                if self._scoring_pool is None:
                    self._scoring_pool = ScoringPool(self.parallel)
        return self._scoring_pool

    def close(self) -> None:
        """Shut down the engine-owned scoring pool (a shared injected pool
        is its owner's to close). Idempotent; a later split batch creates a
        new pool."""
        pool, self._scoring_pool = self._scoring_pool, None
        if pool is not None and self._owns_pool:
            pool.shutdown()
        self._owns_pool = True

    def _plan_spans(self, n_chunks: int) -> List[Tuple[int, int]]:
        """Split ``[0, n_chunks)`` into contiguous near-equal per-worker
        spans; each pads to ``plan.bucket(span_len)``, a bucket of the
        closed set :meth:`warmup` runs."""
        w = self.parallel
        if w <= 1 or n_chunks <= 1:
            return [(0, n_chunks)]
        w = min(w, n_chunks)
        base, rem = divmod(n_chunks, w)
        spans, lo = [], 0
        for i in range(w):
            hi = lo + base + (1 if i < rem else 0)
            spans.append((lo, hi))
            lo = hi
        return spans

    def _compact_grids(self, params, ki_u, row_of_u, slot_of_u,
                       n_chunks: int, nb: int, fcand: int):
        """(scale, zero) grids of the padded block for the host pre-gather,
        gathered **once per unique deduped candidate row** from the host
        mirror and scattered by the same ``(row, slot)`` the codes use.
        Padded slots keep grid zeros (their rows dequantize to exact zeros;
        their outputs are never read). ``None`` on engines whose forward
        takes no host-side grids."""
        emb = params["ffm"]["emb"]
        if not self.host_gather or not Q.is_row_quantized(emb):
            return None
        emb_h, _ = self._host_weights(params)
        s_c = np.zeros((n_chunks, nb, fcand), np.float32)
        z_c = np.zeros((n_chunks, nb, fcand), np.float32)
        s_c[row_of_u, slot_of_u] = emb_h["scale"][ki_u]
        z_c[row_of_u, slot_of_u] = emb_h["zero"][ki_u]
        return s_c, z_c

    def _score_spans(self, params, chunk_state, ki_c, kv_c, grids_c, spans):
        """Score contiguous chunk spans and reassemble ``(logits (n_chunks,
        nb) on the host, ctx_dots (n_chunks, Fc, Fc) on the device | None)``
        in fixed chunk order. One span runs inline; several run through the
        :class:`ScoringPool`: a pool thread prepares span *k+1* (padding,
        stacking the context states and, on a host-gather engine, the host
        gather into a pooled pinned buffer and its upload, on the caller's
        stream) while this thread uploads the indices of span *k* (on an
        engine that gathers on the device) and launches it. Every span
        pads to its own bucket and is sliced back, and the forwards' per-row
        outputs are invariant to the row bucket, so the result is
        bit-identical for every worker count."""
        pool = self._get_pool() if len(spans) > 1 else None
        codes_tbl = None
        if pool is not None and self.host_gather:
            emb_h, _ = self._host_weights(params)
            codes_tbl = emb_h["codes"] if isinstance(emb_h, dict) else emb_h
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def pad_rows(x, rb_s, m):
            if rb_s == m:
                return x
            return np.concatenate(
                [x, np.zeros((rb_s - m,) + x.shape[1:], x.dtype)])

        def prepare(lo, hi):
            m = hi - lo
            rb_s = self.plan.bucket(m, minimum=1)
            ki_b = pad_rows(ki_c[lo:hi], rb_s, m)
            kv_b = pad_rows(kv_c[lo:hi], rb_s, m)
            if not self.host_gather:
                # the upload and the device gather run at dispatch, on the
                # caller's thread
                return ((self._stack_states(chunk_state[lo:hi], rb_s), ki_b,
                         kv_b), m, None, None)
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                grids = None
                if grids_c is not None:
                    grids = (pad_rows(grids_c[0][lo:hi], rb_s, m),
                             pad_rows(grids_c[1][lo:hi], rb_s, m))
                buf = None
                if codes_tbl is not None:
                    buf = pool.acquire(
                        ki_b.shape + codes_tbl.shape[1:],
                        torch.from_numpy(codes_tbl[:0]).dtype,
                        pin_memory=stream is not None)
                fn_args = self._forward_args(
                    params, self._stack_states(chunk_state[lo:hi], rb_s),
                    ki_b, kv_b, grids=grids, out=buf)
                event = None
                if buf is not None and stream is not None:
                    # after the upload: the buffer is free once it completes
                    event = torch.cuda.Event()
                    event.record(stream)
                return fn_args, m, buf, event

        def dispatch(prepared):
            head, m, buf, event = prepared
            try:
                fn, args = (head if self.host_gather
                            else self._forward_args(params, *head))
                fwd = fn(*args)
            finally:
                if buf is not None:
                    # on the card the block was uploaded (the event covers
                    # the copy); on the CPU the forward has read it
                    pool.release(buf, event)
            if self.fused:
                return fwd[0][:m], fwd[1][:m]
            return fwd[:m], None

        def span_cleanup(prepared):
            # a span prepared but never dispatched still holds its buffer
            _, _, buf, event = prepared
            if buf is not None:
                pool.release(buf, event)

        if pool is None:
            parts = [dispatch(prepare(*spans[0]))]
        else:
            parts = pool.run([partial(prepare, lo, hi) for lo, hi in spans],
                             dispatch, cleanup=span_cleanup)
        out = torch.cat([p[0] for p in parts]) if len(parts) > 1 \
            else parts[0][0]
        dots = None
        if self.fused:
            dots = torch.cat([p[1] for p in parts]) if len(parts) > 1 \
                else parts[0][1]
        out = out.cpu().numpy()
        assert out.shape[0] == ki_c.shape[0]
        return out, dots

    def _stack_states(self, chunk_state: List[Dict], rb: int) -> Dict:
        """Stack per-chunk context states along a new row axis, zero-padded
        to ``rb`` rows (a fused state's host-integer ``depth`` uploads as one
        int32 vector)."""
        pad = rb - len(chunk_state)
        out = {}
        for key in chunk_state[0]:
            leaves = [s[key] for s in chunk_state]
            if isinstance(leaves[0], int):
                x = torch.tensor(leaves, dtype=torch.int32, device=self.device)
            else:
                x = torch.stack(leaves)
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            out[key] = x
        return out

    def _upload(self, x) -> torch.Tensor:
        """A host block (numpy, or a pooled torch buffer) on the engine's
        device: ``non_blocking`` on the current stream (asynchronous from a
        pinned buffer); the CPU keeps the block itself."""
        t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        return t.to(self.device, non_blocking=True)

    def _forward_args(self, params, stacked, ki_b: np.ndarray,
                      kv_b: np.ndarray, grids=None, out=None):
        """The forward for one padded candidate block and its arguments, on
        the device: the one argument builder that :meth:`_candidates_forward`,
        the span pipeline's prepare and :meth:`lower_candidates_forward`
        share, so what the roofline counts is what requests run.

        An engine that gathers on the device uploads the indices and values
        and gets :func:`batched_candidates_forward` (or
        :func:`fused_candidates_forward`), which gather by indexing. A
        host-gather engine gathers the candidate codes (or f32 rows) with
        the packed numpy gather from the host mirror, the grids (``grids``:
        the compact-gathered padded ``(scale, zero)`` of
        :meth:`_compact_grids`; ``None`` gathers one per padded slot) and
        the LR terms (summed in the forward, on the device), uploads them
        and gets the pre-gathered forwards.
        ``out``: a pooled host buffer (pinned on the card) the codes or rows
        are gathered into."""
        if not self.host_gather:
            ki = torch.from_numpy(ki_b).to(self.device)
            kv = torch.from_numpy(kv_b).to(self.device)
            if self.fused:
                return fused_candidates_forward, (self.cfg, params, stacked,
                                                  ki, kv)
            return batched_candidates_forward, (
                self.cfg, self.model, self.backend, params, stacked, ki, kv)
        from repro_torch.kernels.row_gather import ops as rg_ops

        emb_h, lr_h = self._host_weights(params)
        kv = self._upload(kv_b)
        lr_terms = self._upload(ffm.gather_lr_np(lr_h, ki_b) * kv_b)
        table = emb_h["codes"] if isinstance(emb_h, dict) else emb_h
        if out is None:
            block = self._upload(rg_ops.gather_codes_np(table, ki_b))
        else:
            rg_ops.gather_codes_np(table, ki_b, out=out.numpy())
            block = self._upload(out)
        if isinstance(emb_h, dict):  # int8 rows: codes + grids
            if grids is None:
                grids = (emb_h["scale"][ki_b], emb_h["zero"][ki_b])
            s, z = self._upload(grids[0]), self._upload(grids[1])
            if self.fused:
                return fused_candidates_forward_q8, (
                    self.cfg, params["lr"]["b"], stacked, block, s, z, kv,
                    lr_terms)
            return batched_candidates_forward_q8, (
                self.cfg, self.model, self.backend, self._head_params(params),
                stacked, block, s, z, kv, lr_terms)
        if self.fused:
            return fused_candidates_forward_rows, (
                self.cfg, params["lr"]["b"], stacked, block, kv, lr_terms)
        return batched_candidates_forward_rows, (
            self.cfg, self.model, self.backend, self._head_params(params),
            stacked, block, kv, lr_terms)

    def _candidates_forward(self, params, stacked, ki_b: np.ndarray,
                            kv_b: np.ndarray, grids=None):
        """One padded candidate block through the engine's forward (see
        :meth:`_forward_args`): ``(logits, ctx_dots)`` on a fused engine,
        logits on a staged one."""
        fn, args = self._forward_args(params, stacked, ki_b, kv_b,
                                      grids=grids)
        return fn(*args)

    def _warmup_dummies(self, rb: int, nb: int):
        """Dummy (cached-state, cand-idx, cand-val) arguments for one
        (row-bucket, candidate-bucket) shape."""
        cfg = self.cfg
        fc, fcand = cfg.context_fields, cfg.n_fields - cfg.context_fields
        emb_dt = ffm.table_dtype(self.params["ffm"]["emb"])

        def zeros(*shape, dt=torch.float32):
            return torch.zeros(shape, dtype=dt, device=self.device)

        cached = {
            "emb": zeros(rb, fc, cfg.n_fields, cfg.k, dt=emb_dt),
            "val": zeros(rb, fc),
            "lr_terms": zeros(rb, fc),
        }
        if self.fused:
            cached["depth"] = zeros(rb, dt=torch.int32)
            cached["pair_sum"] = zeros(rb)
        else:
            cached["pairs"] = zeros(rb, ffm.prefix_pair_count(fc))
        return (cached, np.zeros((rb, nb, fcand), np.int32),
                np.zeros((rb, nb, fcand), np.float32))

    def lower_candidates_forward(self, rb: int, nb: int):
        """The deployed candidate forward at one (row-bucket,
        candidate-bucket) shape and its arguments, ``(fn, args)``: built by
        :meth:`_forward_args` on :meth:`_warmup_dummies`, so ``fn(*args)``
        is the forward requests run (the host pre-gather and the upload,
        when the engine has them, are done). The name is the JAX engine's,
        whose method lowers the jitted forward for its HLO analysis; the
        port has no lowered program, and the roofline counts the ops
        ``fn(*args)`` dispatches (``launch/roofline.py:serving_roofline``)."""
        self._require_params()
        params, _ = self._weights
        return self._forward_args(params, *self._warmup_dummies(rb, nb))

    def host_gather_bytes(self, rb: int, nb: int,
                          unique_rows: Optional[int] = None) -> int:
        """Analytic bytes the *host* pre-gather moves per forward call at one
        (rb, nb) bucket (0 on an engine that gathers on the device), the
        JAX engine's count formula for formula: read + write of every
        gathered block (candidate rows: int8 codes, else f32 rows; LR
        weights) and the index reads; on a quantized engine the f32
        ``(scale, zero)`` grids read and written once per **unique** deduped
        candidate row (``unique_rows``; the padded count by default) plus
        one write per padded slot. An estimate of the dominant streams, not
        a hardware counter; the upload to the card is not in it."""
        self._require_params()
        cfg = self.cfg
        fcand = cfg.n_fields - cfg.context_fields
        rows = rb * nb * fcand
        if not self.host_gather:
            return 0
        emb = self.params["ffm"]["emb"]
        lr_w = self.params["lr"]["w"]
        lr_bytes = 1 + 2 * 4 if Q.is_block_quantized(lr_w) else 4
        idx_bytes = 4
        if Q.is_row_quantized(emb):
            row_bytes = cfg.n_fields * cfg.k            # codes only
            grid_bytes = 2 * 4                          # f32 (scale, zero)
            u_rows = (rows if unique_rows is None
                      else int(unique_rows) * fcand)
            total = rows * (2 * (row_bytes + lr_bytes) + idx_bytes)
            total += grid_bytes * (2 * u_rows + rows)   # compact R+W + scatter
        else:
            row_bytes = cfg.n_fields * cfg.k * 4
            total = rows * (2 * (row_bytes + lr_bytes) + idx_bytes)
        return int(total)

    def warmup(self, *, max_requests: int = 8, max_candidates: int = 64) -> int:
        """Run every (row-bucket, candidate-bucket) shape the engine can
        emit for microbatches of up to ``max_requests`` requests with up to
        ``max_candidates`` candidates each, so the kernel build and every
        first launch happen before traffic (on a host-gather engine, with
        the host mirror built and each shape's host gather and upload run).
        Returns the number of calls."""
        self._require_params()
        self._warmed_buckets = (max_requests, max_candidates)
        params, _ = self._weights
        calls = 0
        for rb in self.plan.buckets_upto(max_requests, minimum=1):
            for nb in self.plan.buckets_upto(max_candidates):
                self._candidates_forward(params, *self._warmup_dummies(rb, nb))
                calls += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return calls

    _warmed_buckets: Optional[Tuple[int, int]] = None  # rotate() re-warms these

    def rotate(self, *, max_depths: int = 4, min_share: float = 0.05,
               warmup_buckets: Optional[Tuple[int, int]] = None
               ) -> "InferenceEngine":
        """Build a warmed successor engine adapted to observed traffic: the
        prefix cache's checkpoint depths from
        :meth:`suggest_checkpoint_depths`, the published params shared by
        reference (quantized tables are adopted, not requantized), the
        generation counter and trainer version carried forward, and the
        warmup bucket set this engine ran (``warmup_buckets`` overrides).
        All of it off the request path; the caller publishes the successor
        (``ShardRouter.rotate_shard`` is that swap)."""
        self._require_params()
        depths = self.suggest_checkpoint_depths(max_depths=max_depths,
                                                min_share=min_share)
        succ = InferenceEngine(
            self.cfg, self.model, backend=self.backend, device=self.device,
            cache_entries=self.cache_entries,
            min_bucket=self.plan.min_bucket, dedup=self.dedup,
            quantized=self.quantized, prefix_depths=depths,
            host_gather=self.host_gather, fused=self.fused,
            parallel=self.parallel)
        succ.weights_version = self.weights_version
        # adopt the published tree by reference and keep the generation
        # monotonic across the swap; written under the successor's lock so
        # the adoption happens-before any read after it is published
        with succ._lock:
            succ._weights = (self.params, self.generation)
        buckets = warmup_buckets or self._warmed_buckets
        if buckets is not None:
            succ.warmup(max_requests=buckets[0], max_candidates=buckets[1])
        return succ

    def score_uncached(self, ctx_idx, ctx_val, cand_idx, cand_val,
                       use_backend: bool = False) -> torch.Tensor:
        """Baseline: full forward per candidate (context recomputed each time).

        ``use_backend=True`` routes the interaction hot loop through the
        interaction kernel when the backend is ``"cuda"``; the default stays
        on the plain path so it can serve as the equivalence oracle. On a
        quantized engine this scores against the *quantized* tables (rows
        dequantized per gather) — the roundtrip oracle for the quantized
        cached path. Returns logits (N,) on the engine's device.
        """
        self._require_params()
        ci = np.asarray(ctx_idx, np.int32)
        ki = np.asarray(cand_idx, np.int32)
        self._check_indices(ci, ki)
        n = ki.shape[0]
        fc = self.cfg.context_fields
        idx = np.concatenate([np.broadcast_to(ci, (n, fc)), ki], axis=1)
        val = np.concatenate(
            [np.broadcast_to(np.asarray(ctx_val, np.float32), (n, fc)),
             np.asarray(cand_val, np.float32)], axis=1)
        interactions_fn = None
        if use_backend and self.backend == "cuda":
            from repro_torch.kernels.ffm_interaction import ops as ffm_ops

            interactions_fn = ffm_ops.interactions
        return deepffm.forward(
            self.cfg, self.params,
            torch.from_numpy(idx).to(self.device),
            torch.from_numpy(val).to(self.device),
            self.model, interactions_fn=interactions_fn)
