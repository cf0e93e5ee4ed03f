"""The serving stack's declared global lock partial order (a copy of
``repro/analysis/lock_order.py``; the port imports nothing of ``repro``).

One table, read by the port's runtime witness
(:mod:`repro_torch.analysis.lock_witness`): a thread may acquire lock B
while holding lock A only if ``rank(A) < rank(B)``.  Acquiring equal-rank locks
while holding one (two instances of the same lock attribute, or two
unordered peers) is also a violation — peers have no declared order, so
nesting them is a latent deadlock.

The order below is the one the code obeys, verified by the witness on the
concurrency tests of both packages. The names are the JAX package's, so one
order covers both:

``ShardRouter._fleet_lock``
    Fleet topology (kill/refresh/prober start).  Outermost; never taken
    while any other named lock is held.
``UpdatePipe._ingest_lock``
    Serializes receiver mutation + publish.  Holds ``_pipe_lock`` (the
    ``rotate_shard`` re-point, the declared cross-object pair), the engine
    ``_lock`` (publish/prewarm run under an ingest), and ``_pending_cv``
    (the hurry-flag read) — so it ranks above all three.
``InferenceEngine._pipe_lock``
    Pipe construction/handoff.  Taken inside ``rotate_shard``'s ingest
    lock; holds nothing else.
``InferenceEngine._lock``
    Cache structure + counters + weights tuple.  Innermost of the
    engine-level locks; may wrap only leaf locks.
``UpdatePipe._pending_cv`` / ``UpdatePipe._thread_lock`` /
``ScoringPool._buf_lock``
    Queue accounting, thread spawn, gather-buffer free list.
``ReplicaHealth._lock`` / ``FaultPlan._lock`` / ``_calibrate_lock`` /
hogwild's local ``lock``
    Leaves: self-contained critical sections that never take another lock.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

# Qualified lock name -> rank.  Lower rank = acquired first (outermost).
LOCK_RANKS: Dict[str, int] = {
    "ShardRouter._fleet_lock": 10,
    "UpdatePipe._ingest_lock": 20,
    "InferenceEngine._pipe_lock": 30,
    "InferenceEngine._lock": 40,
    "UpdatePipe._pending_cv": 50,
    "UpdatePipe._thread_lock": 60,
    "ScoringPool._buf_lock": 70,
    # leaves — acquired under anything above, hold nothing below
    "ReplicaHealth._lock": 80,
    "FaultPlan._lock": 85,
    "row_gather._calibrate_lock": 90,
    "hogwild.lock": 95,
}

# Documented pairwise nestings observed in the code (A held while acquiring
# B).  Informational — the ranks above are the machine-checked contract; this
# list pins *why* each non-leaf lock outranks the ones below it.
OBSERVED_NESTINGS: Tuple[Tuple[str, str, str], ...] = (
    ("UpdatePipe._ingest_lock", "InferenceEngine._pipe_lock",
     "shard_router.ShardRouter.rotate_shard: pipe re-point to the successor"),
    ("UpdatePipe._ingest_lock", "InferenceEngine._lock",
     "update_pipe._ingest_locked -> engine._publish / prewarm_contexts"),
    ("UpdatePipe._ingest_lock", "UpdatePipe._pending_cv",
     "update_pipe.ingest drain check / _hurried read under an ingest"),
    ("InferenceEngine._lock", "ScoringPool._buf_lock",
     "declared headroom: cache ops may hand out gather buffers"),
)


def rank_of(qualname: str) -> Optional[int]:
    return LOCK_RANKS.get(qualname)
