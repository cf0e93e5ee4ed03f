"""Serving launcher: batched greedy decode with KV caches (port of
``repro/launch/serve.py``; ``--device`` picks the card or the CPU). An
``encdec`` model first encodes 16 stub frames (seeded, seed 1) into its
cross caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --smoke --device cpu --batch 2 --gen 4
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch seamless-m4t-large-v2 --smoke --device cpu
"""
import argparse
import sys
import time

SRC_LEN = 16  # an encdec model's stub frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    from repro_torch.models import registry
    from repro_torch.train.steps import make_serve_step

    cfg = registry.get_config(args.arch, smoke=args.smoke)
    params = registry.init_params(cfg, 0, args.device)
    kw = {"src_len": SRC_LEN} if cfg.family == "encdec" else {}
    state = registry.init_decode_state(cfg, args.batch, args.gen + 1,
                                       window=args.window, device=args.device,
                                       **kw)
    serve = make_serve_step(cfg, window=args.window)
    toks = torch.zeros((args.batch,), dtype=torch.int32, device=args.device)

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    with torch.inference_mode():
        if cfg.family == "encdec":
            from repro_torch.models import encdec

            gen = torch.Generator(device=args.device).manual_seed(1)
            frames = torch.randn((args.batch, SRC_LEN, cfg.d_model),
                                 generator=gen, device=args.device)
            state = encdec.prefill_cross(cfg, params, state, frames)
        toks, state = serve(params, state, toks)  # first call (warm-up)
        sync()
        t0 = time.time()
        for _ in range(args.gen):
            toks, state = serve(params, state, toks)
        sync()
    dt = time.time() - t0
    print(f"{args.arch} on {args.device}: {args.batch}x{args.gen} tokens in "
          f"{dt:.2f}s ({args.batch*args.gen/max(dt,1e-9):.1f} tok/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
