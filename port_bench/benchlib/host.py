"""What the host did while a window ran, read from the run's own process
and from ``/proc``: the process's CPU seconds and involuntary context
switches, the machine's busy and stolen shares of its CPU time, the mean
clock of its cores and its load, and the seconds a fixed piece of host
work takes before and after the window (``probe_ms``). A host-bound
program's rate follows the host's speed; these numbers tell a slower host
from a slower program. (A sandbox may serve ``/proc`` from a fixed copy:
then its shares are absent and its clock and load do not move.)
"""
from __future__ import annotations

import resource
import subprocess
import time
from typing import Dict, Optional

import numpy as np


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as fh:
            return fh.read()
    except OSError:
        return None


def _mhz() -> Optional[float]:
    text = _read("/proc/cpuinfo") or ""
    mhz = [float(line.split(":")[1]) for line in text.splitlines()
           if line.startswith("cpu MHz")]
    return sum(mhz) / len(mhz) if mhz else None


def probe_ms() -> float:
    """Milliseconds of a fixed piece of host work like the program's own
    (sorting 64 k keys, a Python loop), the least of three tries."""
    keys = np.random.default_rng(0).integers(0, 1 << 40, 1 << 16)
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(4):
            np.unique(keys)
        acc = 0
        for i in range(50_000):
            acc += i & 7
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def gpu_clocks() -> Optional[str]:
    """The card's SM and memory clocks (MHz), power (W) and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
             "temperature.gpu", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def snapshot(end: bool = False) -> Dict[str, float]:
    """The counters, with the probe and the card's clocks read before them
    at a window's start and after them at its end, outside the interval."""
    snap = {} if end else {"probe_ms": probe_ms(), "gpu": gpu_clocks()}
    ru = resource.getrusage(resource.RUSAGE_SELF)
    snap.update(t=time.perf_counter(), cpu_s=ru.ru_utime + ru.ru_stime,
                invol=float(ru.ru_nivcsw))
    stat = _read("/proc/stat")
    if stat:
        # user nice system idle iowait irq softirq steal (guest counted in user)
        ticks = [float(x) for x in stat.splitlines()[0].split()[1:9]]
        snap.update(total=sum(ticks), idle=ticks[3] + ticks[4],
                    steal=ticks[7])
    if end:
        snap.update(probe_ms=probe_ms(), gpu=gpu_clocks())
    return snap


def window(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """The host over the interval between a window's two snapshots."""
    out = {"process_cpu_s": b["cpu_s"] - a["cpu_s"],
           "wall_s": b["t"] - a["t"],
           "invol_switches": b["invol"] - a["invol"],
           "probe_ms_before": a["probe_ms"], "probe_ms_after": b["probe_ms"],
           "gpu_before": a["gpu"], "gpu_after": b["gpu"]}
    if "total" in a and b["total"] > a["total"]:
        dt = b["total"] - a["total"]
        out["machine_busy"] = 1.0 - (b["idle"] - a["idle"]) / dt
        out["machine_steal"] = (b["steal"] - a["steal"]) / dt
    mhz = _mhz()
    if mhz is not None:
        out["cpu_mhz"] = mhz
    load = _read("/proc/loadavg")
    if load:
        out["load1"] = float(load.split()[0])
    return out
