"""Share of the traced part of the training window (one whole round) in which no operation
ran on the device, in percent (the profiler's trace)."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
