"""A traced session that lost its kernel records gives way to another.

On the CPU, with a stand-in for the tracer whose first sessions report no
kernel: each loop traces again, takes the traced counters from the session
that recorded its kernels (or the last), and stops after ``trace.TRIES``
sessions; the training loop's sessions are whole rounds of its window."""
from __future__ import annotations

import pytest

import pb_tiny
from benchlib import spec, trace


class LosingTracer:
    """Reports its first ``lose`` sessions as holding no kernel."""

    def __init__(self, lose: int):
        self.lose, self.starts, self.stops = lose, 0, 0

    def start(self) -> None:
        assert self.starts == self.stops
        self.starts += 1

    def stop(self) -> bool:
        self.stops += 1
        return self.stops > self.lose


def _measure(name, tracer, seconds):
    cell = pb_tiny.tiny_cell(name)
    loop = spec.loop_module(cell).Loop(cell, pb_tiny.SEED, "cpu")
    loop.setup()
    try:
        return loop.measure(seconds, tracer)
    finally:
        loop.release()


@pytest.mark.parametrize("lose", [0, 1, trace.TRIES])
@pytest.mark.parametrize("name", pb_tiny.CELLS)
def test_a_session_without_kernels_is_traced_again(name, lose):
    tracer = LosingTracer(lose)
    win = _measure(name, tracer, 1.5)
    tries = min(lose + 1, trace.TRIES)
    if "train" in name:  # a round a session, as many as the window holds
        tries = min(tries, win.counters["rounds"])
    assert tracer.starts == tracer.stops == tries
    assert win.traced, "the traced counters of the last session"
    key = "examples" if "train" in name else "rows_scored"
    assert win.traced[key] > 0
