"""Training launcher: Adam (or AdaGrad) steps of an arch id's model on the
synthetic token stream (port of ``repro/launch/train.py``; ``--device``
picks the card or the CPU). An ``encdec`` model is fed zero frames, as in
the JAX package. The JAX launcher's ``--mesh`` and ``--devices`` are
distribution tooling and not ported (ROADMAP.md Queue 1 item 9).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --device cpu --steps 5
"""
import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint import store
    from repro_torch.common.pspec import torch_dtype
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import make_train_step

    cfg = registry.get_config(args.arch, smoke=args.smoke)
    params = registry.init_params(cfg, 0, args.device)
    opt = make_optimizer(args.optimizer, lr=1e-3)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    step = 0
    t0 = time.perf_counter()
    for i, batch in enumerate(
            lm_batches(cfg.vocab_size, args.batch, args.seq, args.steps)):
        b = {k: torch.from_numpy(v).to(args.device) for k, v in batch.items()}
        if cfg.family == "encdec":
            b["frames"] = torch.zeros((args.batch, args.seq, cfg.d_model),
                                      dtype=torch_dtype(cfg.dtype),
                                      device=args.device)
        params, opt_state, step, m = step_fn(params, opt_state, step, b)
        print(f"step {i}: loss={float(m['loss']):.4f}", flush=True)
    print(f"{args.arch} on {args.device}: {args.steps} steps of "
          f"{args.batch}x{args.seq} tokens in {time.perf_counter() - t0:.2f}s")
    if args.ckpt:
        store.save(args.ckpt, params, opt_state)
        print(f"checkpointed to {args.ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
