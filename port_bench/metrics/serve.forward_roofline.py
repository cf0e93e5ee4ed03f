"""The candidate forward's kernels against their roofline, in percent: the
least time the chip needs for the work of the rows scored in the traced
part of the window (K3, or K5 on a fused engine; K1 for the context tails;
the head's matrix products), by the yardstick's frozen counts, over the
device time the trace gives those kernels. The counts take the rows scored
after dedup and before padding, so padding never counts as work."""

KERNELS = ("gather_dequant_rows", "ffm_candidate", "ffm_fused_logits",
           "gemm", "gemv")


def read(run):
    t = run.trace
    rows = run.traced.get("rows_scored", 0)
    if t is None or not rows:
        return None
    seconds = t.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    w, cfg = run.work, run.cfg
    fc, f, k = cfg["context_fields"], cfg["n_fields"], cfg["k"]
    if cfg["fused"]:
        flops, nbytes = w.k5_work(1, rows, fc, f - fc, k)
    else:
        flops, nbytes = w.k3_work(1, rows, fc, f - fc, k)
        hf, hb = w.head_work(cfg, rows)
        flops, nbytes = flops + hf, nbytes + hb
    kf, kb = w.k1_work(run.traced.get("ctx_tail_fields", 0), f * k)
    return 100.0 * w.bound_seconds(flops + kf, nbytes + kb) / seconds
