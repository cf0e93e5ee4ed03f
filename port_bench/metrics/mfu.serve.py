"""The scoring step's share of the chip's published peak in the precision it computes in (the configurations: float32), in
percent: the frozen operation count of every row scored in the window
(``work.serve_row_flops``) over the window's length times the peak."""


def read(run):
    rows = run.counters.get("rows_scored", 0)
    if not rows:
        return None
    flops = rows * run.work.serve_row_flops(run.cfg)
    return 100.0 * flops / (run.seconds * run.work.PEAK_FLOPS[run.cfg["dtype"]])
