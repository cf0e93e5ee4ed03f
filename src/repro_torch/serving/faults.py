"""Deterministic fault injection for the serving fleet (port of
``repro/serving/faults.py``; host only).

The paper's deployment regime — CPU fleets across several data centers fed
by a continuous weight-update stream — treats shard death, slow boxes, and
mangled transfers as routine. Testing that regime needs failures that are
*repeatable*: a seeded :class:`FaultPlan` is a declarative schedule of
faults, injected through hooks in :class:`~repro_torch.serving.shard_router
.ShardRouter` (replica death at round *k*, per-call latency spikes, hard
call failures), :class:`~repro_torch.checkpoint.transfer.ShardedSender` (frame
drop / truncate / bit-flip on the way out), and
:class:`~repro_torch.serving.update_pipe.UpdatePipe` (slow-ingest throttling).

Every hook site guards with ``if plan is None`` — an unset plan is zero
overhead on the serving path. All schedule lookups are pure functions of
the plan's dicts plus internal per-site counters, so the same plan driven
by the same traffic produces byte-identical fault sequences; corruption
offsets derive from ``seed``, never from a live RNG or the clock.
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class FaultInjected(RuntimeError):
    """Raised by a replica-call hook to simulate a hard shard failure."""


FRAME_DROP, FRAME_TRUNCATE, FRAME_BITFLIP = "drop", "truncate", "bitflip"


@dataclass
class FaultPlan:
    """Seeded, declarative failure schedule.

    ``kill_at``      — ``(shard, replica) -> round``: the router kills that
                       replica at the start of the given 1-based scoring
                       round (``score_batch`` call).
    ``latency_s``    — ``(shard, replica) -> seconds``: every partial-sum
                       call on that replica sleeps first (straggler).
    ``fail_calls``   — ``(shard, replica) -> n``: the replica's first ``n``
                       calls raise :class:`FaultInjected` (``-1`` = every
                       call fails — a black-holed box).
    ``frame_faults`` — ``(shard, nth_frame) -> action``: the shard's n-th
                       outgoing frame (0-based, counted at the sender) is
                       dropped, truncated, or bit-flipped.
    ``ingest_sleep_s`` — every pipe ingest sleeps this long first (slow
                       decode host).
    """

    seed: int = 0
    kill_at: Dict[Tuple[int, int], int] = field(default_factory=dict)
    latency_s: Dict[Tuple[int, int], float] = field(default_factory=dict)
    fail_calls: Dict[Tuple[int, int], int] = field(default_factory=dict)
    frame_faults: Dict[Tuple[int, int], str] = field(default_factory=dict)
    ingest_sleep_s: float = 0.0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._round = 0
        self._calls: Counter = Counter()   # (shard, replica) -> calls seen
        self._frames: Counter = Counter()  # shard -> frames seen
        self._killed: set = set()

    @property
    def round(self) -> int:
        with self._lock:
            return self._round

    # -- ShardRouter hooks --------------------------------------------------
    def next_round(self) -> List[Tuple[int, int]]:
        """Advance the scoring-round counter; return the ``(shard, replica)``
        deaths whose scheduled round has arrived (each fires once)."""
        with self._lock:
            self._round += 1
            due = sorted(sr for sr, k in self.kill_at.items()
                         if k <= self._round and sr not in self._killed)
            self._killed.update(due)
        return due

    def on_replica_call(self, shard: int, replica: int) -> None:
        """Per partial-sum call: inject the scheduled latency spike and/or
        hard failure for this replica."""
        key = (shard, replica)
        with self._lock:
            n = self._calls[key]
            self._calls[key] = n + 1
        spike = self.latency_s.get(key)
        if spike:
            time.sleep(spike)
        fail = self.fail_calls.get(key)
        if fail is not None and (fail < 0 or n < fail):
            raise FaultInjected(
                f"injected failure on shard {shard} replica {replica} "
                f"(call {n})")

    # -- ShardedSender hook -------------------------------------------------
    def corrupt_frame(self, shard: int,
                      frame: Optional[bytes]) -> Optional[bytes]:
        """Apply the scheduled wire fault to the shard's n-th outgoing frame.
        Drop returns ``None``; truncate/bit-flip positions are pure functions
        of ``seed`` and the frame counter."""
        if frame is None:
            return None
        with self._lock:
            n = self._frames[shard]
            self._frames[shard] = n + 1
        action = self.frame_faults.get((shard, n))
        if action is None:
            return frame
        if action == FRAME_DROP:
            return None
        if action == FRAME_TRUNCATE:
            keep = 1 + (self.seed + 7919 * n) % max(len(frame) - 1, 1)
            return frame[:keep]
        if action == FRAME_BITFLIP:
            pos = (1000003 * (self.seed + 1) + 31 * n) % len(frame)
            bit = (self.seed + n) % 8
            out = bytearray(frame)
            out[pos] ^= 1 << bit
            return bytes(out)
        raise ValueError(f"unknown frame fault {action!r}")

    # -- UpdatePipe hook ----------------------------------------------------
    def on_ingest(self, nbytes: int) -> None:
        """Per frame ingest: scheduled slow-decode throttling."""
        if self.ingest_sleep_s:
            time.sleep(self.ingest_sleep_s)
