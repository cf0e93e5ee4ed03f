"""The device trace of a traced window, from ``torch.profiler`` (CUPTI on
the card): when an operation ran on the device, which kernels took the
time, and what the host was doing while the device sat idle.

``busy_s`` is the union of the device intervals (kernels, copies, sets)
and ``window_s`` the span of the whole trace, host events included, in the
trace's own clock, so the two are in one time base.

A session can come back with copies but no kernel at all although kernels
ran (seen once on an H100: busy 1.7 ms of 2 s, memcpy only, at the usual
rate of rows scored). :meth:`Tracer.stop` says whether a session holds a
kernel, so that a loop traces another part of its window in place of a
session that lost them (``TRIES`` sessions at most).
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

LABELLED_GAPS = 2000  # the longest idle gaps given a host label
TRIES = 3             # traced sessions a run may take to record its kernels
COPY_PREFIXES = ("Memcpy", "Memset")  # device records that are not kernels


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]          # device seconds by operation name
    idle_by_host: List[Tuple[str, float]] = field(default_factory=list)

    def seconds_of(self, patterns: Sequence[str]) -> float:
        """Device seconds of the operations whose name holds any of
        ``patterns`` (case-insensitive)."""
        pats = [p.lower() for p in patterns]
        return sum(t for name, t in self.kernel_s.items()
                   if any(p in name.lower() for p in pats))

    def breakdown(self) -> Dict[str, List]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in self.idle_by_host[:10]]}


class Tracer:
    """Starts and stops one profiler session; :meth:`summary` reads it."""

    def __init__(self):
        self._prof = None

    @staticmethod
    def _new():
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        try:  # the host side of every thread, not only the caller's
            cfg = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            return profile(activities=acts)
        return profile(activities=acts, experimental_config=cfg)

    def prime(self) -> None:
        """One empty session, so that the tracer's own start-up is set-up
        and not part of a traced window."""
        prof = self._new()
        prof.start()
        prof.stop()

    def start(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof = self._new()
        self._prof.start()

    def stop(self) -> bool:
        """Ends the session; True if it recorded a kernel (or there is no
        card to record one on), else False, with the device records it
        did hold written to standard error."""
        import torch
        if not torch.cuda.is_available():
            self._prof.stop()
            return True
        torch.cuda.synchronize()
        self._prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        try:
            raw = self._prof.profiler.kineto_results.events()
            dev = [e.name() for e in raw if e.device_type() == cuda]
        except AttributeError:  # no raw results: read the parsed events
            dev = [e.name for e in self._prof.events()
                   if e.device_type == cuda]
        kernels = sum(not n.startswith(COPY_PREFIXES) for n in dev)
        if not kernels:
            print(f"port_bench: a traced session without kernel records "
                  f"({len(dev)} copy or set records)", file=sys.stderr,
                  flush=True)
        return kernels > 0

    def summary(self) -> TraceSummary:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        dev, cpu = [], []
        kernel_s: Dict[str, float] = defaultdict(float)
        lo, hi = float("inf"), float("-inf")
        for e in self._prof.events():
            s, t = e.time_range.start, e.time_range.end
            lo, hi = min(lo, s), max(hi, t)
            if e.device_type == cuda:
                dev.append((s, t))
                kernel_s[e.name] += (t - s) * 1e-6
            else:
                cpu.append((s, t, e.name))
        self._prof = None
        if not dev:
            return TraceSummary(0.0, max(hi - lo, 0.0) * 1e-6, {})
        dev.sort()
        merged = [list(dev[0])]
        for s, t in dev[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged)
        gaps = [(merged[0][0] - lo, lo, merged[0][0])]
        gaps += [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])]
        gaps.append((hi - merged[-1][1], merged[-1][1], hi))
        return TraceSummary(busy * 1e-6, (hi - lo) * 1e-6, dict(kernel_s),
                            _label_gaps(gaps, cpu))


def _label_gaps(gaps, cpu) -> List[Tuple[str, float]]:
    """Idle seconds by the innermost host operation running at each gap's
    middle (the longest gaps; the rest summed apart)."""
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps.sort(reverse=True)
    by: Dict[str, float] = defaultdict(float)
    for length, g0, g1 in gaps[:LABELLED_GAPS]:
        mid = 0.5 * (g0 + g1)
        label = "host: outside torch ops (Python, numpy)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 256, -1), -1):
            if cpu[j][1] >= mid:  # the latest-started op still running
                label = cpu[j][2]
                break
        by[label] += length * 1e-6
    rest = sum(g[0] for g in gaps[LABELLED_GAPS:]) * 1e-6
    if rest:
        by["(shorter gaps)"] += rest
    return sorted(by.items(), key=lambda kv: -kv[1])
