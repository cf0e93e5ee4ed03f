"""The training step's share of the chip's published peak in the precision it computes in (the configurations: float32), in
percent: the frozen forward-and-backward operation count of every example
trained in the window (``work.train_example_flops``) over the window's
length times the peak."""


def read(run):
    ex = run.counters.get("examples", 0)
    if not ex:
        return None
    flops = ex * run.work.train_example_flops(run.cfg)
    return 100.0 * flops / (run.seconds * run.work.PEAK_FLOPS[run.cfg["dtype"]])
