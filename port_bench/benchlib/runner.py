"""One run of one cell: set-up, the measured window, the program freed,
the comparison with the reference, and the result line's contents.

A loop (``loops/<kind>.py``) gives a ``Loop(cell, seed, device)``
with ``setup()``, ``measure(seconds, tracer) -> Window``, ``release()``
and ``check(control) -> {number: value}``. This module keeps the order the
contract sets: nothing of the reference runs before the window has closed,
the device's peak has been read and the program's state freed.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from benchlib import host
from benchlib import spec as spec_mod
from benchlib import work
from benchlib.trace import TraceSummary, Tracer


@dataclass
class Window:
    """What a loop's measured window hands back."""

    e2e: Dict[str, float]                 # end-to-end metric -> value
    counters: Dict[str, float]            # the program's counters, window
    traced: Dict[str, float] = field(default_factory=dict)  # traced part
    attempted: int = 0
    failed: int = 0
    seconds: float = 0.0                  # the window's length


@dataclass
class Run:
    """What a per-layer metric's reader is given."""

    cell: spec_mod.Cell
    seconds: float
    counters: Dict[str, float]
    traced: Dict[str, float]
    trace: Optional[TraceSummary]
    work = work

    @property
    def cfg(self) -> Dict:
        return self.cell.config


_T0 = [time.perf_counter()]  # the run's start, for the account's times


def log(msg: str) -> None:
    """A line of the run's account on standard error, with the seconds
    since the run started."""
    print(f"port_bench: {time.perf_counter() - _T0[0]:8.2f} s {msg}",
          file=sys.stderr, flush=True)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run_cell(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: Optional[str] = None,
             t_start: Optional[float] = None) -> Dict:
    """Returns the result line's object; its last key, ``checks``, holds
    each compared number beside its limit."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    _T0[0] = t_start
    drv = spec_mod.loop_module(cell).Loop(cell, seed, device)
    tracer = Tracer() if trace else None
    drv.setup()
    if tracer is not None:
        tracer.prime()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    before = host.snapshot()
    win = drv.measure(seconds, tracer)
    host_window = host.window(before, host.snapshot(end=True))
    on_card = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary = tracer.summary() if tracer is not None else None
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    log(f"window {win.seconds:.3f} s; counters {win.counters}")
    log(f"host {host_window}")
    values = drv.check(control)
    log("comparison done")
    checks, correct = {}, win.failed == 0
    for name, value in values.items():
        lim = spec_mod.limit(cell, name)
        checks[name] = {"value": value, "limit": lim}
        if lim is None or not _finite(value) or value > lim:
            correct = False

    if trace:
        run = Run(cell, win.seconds, win.counters, win.traced, summary)
        metrics = {}
        for m in cell.per_layer:
            v = spec_mod.metric_reader(cell, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        have = dict(win.e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": have[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in have}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    out = {"correct": bool(correct), "attempted": int(win.attempted),
           "failed": int(win.failed), "metrics": metrics, "device": dev}
    if summary is not None:
        out["breakdown"] = summary.breakdown()
    out["host"] = host_window
    out["checks"] = checks
    return out
