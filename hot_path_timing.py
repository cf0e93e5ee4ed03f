#!/usr/bin/env python3
"""The port's host-bound hot paths timed on one CUDA card, so that two
trees of the port can be compared within one call:

    python3 hot_path_timing.py [--src DIR] [--reps N] [--device cuda|cpu]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
the one beside this script), so that a second tree unpacked elsewhere is
timed by the same code. Run trees A, B, B, A in one session and compare
within it. Each path is warmed up, then timed ``--reps`` times with the
card synchronized before each clock read (host wall clock):

* ``ffm_int8`` / ``ffm_f32``: one ``InferenceEngine.score_batch``
  microbatch of the DeepFFM engines at ``FFMConfig()``'s full width on
  chip_smoke.py's traffic (``make_traffic``), ms per microbatch;
* ``ffm_int8_fused`` / ``ffm_f32_fused``: the same for the fused ``"ffm"``
  engines (K5 / K6);
* ``llm_prefill``: llama3.2-1b (bf16, full width), ``transformer.prefill``
  of 4 x 1024 prompt tokens (K11 once per layer);
* ``llm_decode``: one greedy ``make_serve_step`` step after that prefill;
* ``mesh_train``: ``make_train_step(cfg, adam, rt)`` on a one-rank mesh
  (NCCL), llama3.2-1b at 4 x 1024 (K11 / K13 / K12 once per layer).

Prints one line per path and, last, one JSON object with every reading.
``--device cpu`` runs the same paths at small sizes as a rehearsal (its
times are the CPU's, not the card's).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("hot_path_timing: CUDA is not available", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))  # chip_smoke's traffic
    import chip_smoke
    from repro_torch.common.config import FFMConfig
    from repro_torch.configs import llama32_1b
    from repro_torch.core import deepffm
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.models import registry, transformer
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    small = not on_card
    smi = ""
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    import repro_torch
    print(f"hot_path_timing: {Path(repro_torch.__file__).parent} | torch "
          f"{torch.__version__} | {smi}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(name, fn, reps, warm=2):
        for _ in range(warm):
            fn()
        ms = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        med = statistics.median(ms)
        print(f"{name}: median {med:.4f} ms, min {min(ms):.4f}, max "
              f"{max(ms):.4f} over {reps}")
        out[name] = {"median_ms": med, "ms": ms}

    out = {}
    # the DeepFFM engines
    cfg = (FFMConfig(n_fields=8, context_fields=5, hash_space=2**10, k=4,
                     mlp_hidden=(16, 8)) if small else FFMConfig())
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = deepffm.init_params(cfg, args.seed, "deepffm", dev)
    last = f"w{len(cfg.mlp_hidden)}"
    params["mlp"][last] = torch.randn(params["mlp"][last].shape,
                                      generator=gen, device=dev) * 0.5
    params["lr"]["w"] = torch.randn(cfg.hash_space, generator=gen,
                                    device=dev) * 0.1
    batches = chip_smoke.make_traffic(cfg, np.random.default_rng(args.seed))
    fparams = deepffm.init_params(cfg, args.seed + 1, "ffm", dev)
    fparams["lr"]["w"] = params["lr"]["w"].clone()
    for name, model, p, quant, fused in (
            ("ffm_int8", "deepffm", params, True, False),
            ("ffm_f32", "deepffm", params, False, False),
            ("ffm_int8_fused", "ffm", fparams, True, True),
            ("ffm_f32_fused", "ffm", fparams, False, True)):
        eng = InferenceEngine(cfg, model, backend="cuda", params=p,
                              device=dev, quantized=quant, fused=fused)
        eng.warmup(max_requests=8, max_candidates=64)
        it = iter(range(10**9))
        timed(name, lambda eng=eng, it=it: eng.score_batch(
            batches[next(it) % len(batches)]), args.reps)
        del eng
    del params, fparams

    # llama3.2-1b: prefill, then decode steps after it
    llm = llama32_1b.smoke() if small else llama32_1b.config()
    b, p_len = (2, 16) if small else (4, 1024)
    lparams = registry.init_params(llm, args.seed, dev)
    prompts = torch.randint(0, llm.vocab_size, (b, p_len), generator=gen,
                            device=dev, dtype=torch.int32)
    n_dec = args.reps + 2

    def prefill():
        with torch.inference_mode():
            state = registry.init_decode_state(llm, b, p_len + n_dec + 1,
                                               device=dev)
            return transformer.prefill(llm, lparams, prompts, state)

    timed("llm_prefill", prefill, max(3, args.reps // 3))
    serve_step = steps.make_serve_step(llm)
    lg, dec_state = prefill()
    toks = torch.argmax(lg, dim=-1).to(torch.int32)

    def decode():
        nonlocal toks, dec_state
        with torch.inference_mode():
            toks, dec_state = serve_step(lparams, dec_state, toks)

    timed("llm_decode", decode, args.reps)
    del lparams, dec_state, lg
    if on_card:
        torch.cuda.empty_cache()

    # the sharded train step on a one-rank mesh
    with contextlib.ExitStack() as world:
        world.enter_context(mesh_lib.world(dev))
        rt = mesh_lib.make_runtime(mesh_lib.make_smoke_mesh(1, 1))
        bt, st = (2, 16) if small else (4, 1024)
        full = registry.init_params(llm, args.seed, dev)
        specs = sharding.param_shardings(llm, registry.param_axes(llm), full,
                                         rt.mesh)
        tparams = sharding.local_tree(full, specs, rt)
        del full
        opt = make_optimizer("adam", lr=1e-3)
        # a tree without ZeRO-1 takes the optimizer's own state (on a
        # one-rank mesh its ZeRO-1 slices are the whole leaves)
        init = getattr(steps, "init_opt_state", None)
        state = (init(llm, opt, tparams, rt) if init is not None
                 else opt.init(tparams))
        step_fn = steps.make_train_step(llm, opt, rt)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
            lm_batches(llm.vocab_size, bt, st, 1, seed=args.seed)).items()}
        step_no = iter(range(10**9))
        timed("mesh_train", lambda: step_fn(tparams, state, next(step_no),
                                            batch), max(3, args.reps // 3))
        del tparams, state
    print(json.dumps({"src": str(src), "device": smi or args.device,
                      "timings": {k: v["median_ms"] for k, v in out.items()},
                      "all_ms": {k: v["ms"] for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
