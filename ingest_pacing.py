#!/usr/bin/env python3
"""Scorer latency on the card while the update pipe ingests a frame in the
background, with the frame's codes copied to the card in one copy (as
``transfer.Receiver`` does) and in paced chunks (256 Ki codes with a 2 ms
sleep after each, the throttle the JAX package puts on its host decode).

    python3 ingest_pacing.py [--rounds 8] [--seed 0]

A full-width int8 DeepFFM engine (``FFMConfig()``, random weights from a
seed, ``backend="cuda"``) takes a full frame; then each round submits a
patch frame (5% of the rows moved) per variant, alternating which goes
first, while the main thread scores ``chip_smoke.make_traffic``
microbatches until the pipe publishes. Idle scoring (no ingest) runs
before each round. Prints, per variant, over the whole ingest and over the
microbatches that overlap the copy of the codes: the microbatch count, p50
/ p99 / max wall ms, and per ingest the microbatches slower than the idle
p99 and the scorers' ms beyond the idle p50; and the copy's and the
ingest's (submit to publish) wall ms.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent
PACE_CHUNK, PACE_SLEEP_S = 256 * 1024, 0.002
IDLE_S = 1.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ingest_pacing: CUDA is not available; no result",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint import transfer as T
    from repro_torch.common import device as device_mod
    from repro_torch.common.config import FFMConfig
    from repro_torch.core import deepffm
    from repro_torch.serving.engine import InferenceEngine

    dev = torch.device("cuda")
    smi = device_mod.describe(dev)["nvidia_smi"]
    cfg = FFMConfig()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = deepffm.init_params(cfg, args.seed, "deepffm", dev)
    snd = T.Sender(device=dev)
    eng = InferenceEngine(cfg, "deepffm", backend="cuda", device=dev,
                          quantized=True)
    eng.apply_update(snd.make_update(params), snd.manifest, params)
    eng.warmup(max_requests=8, max_candidates=64)
    batches = chip_smoke.make_traffic(cfg, np.random.default_rng(args.seed))
    pipe = eng.update_pipe()
    one_copy = T._upload_codes
    copies = []  # (start, end) host times of every upload of the codes

    def paced_copy(q, device):
        host = torch.from_numpy(np.array(q.view(np.int16)))
        out = torch.empty(host.shape, dtype=torch.int16, device=device)
        for off in range(0, host.numel(), PACE_CHUNK):
            out[off:off + PACE_CHUNK].copy_(host[off:off + PACE_CHUNK])
            time.sleep(PACE_SLEEP_S)
        return out

    def timed_copy(upload):
        def run(q, device):
            t0 = time.perf_counter()
            out = upload(q, device)
            torch.cuda.current_stream(device).synchronize()  # the pipe's
            copies.append((t0, time.perf_counter()))
            return out
        return run

    def moved(p):
        rows = torch.randperm(cfg.hash_space, generator=gen,
                              device=dev)[:cfg.hash_space // 20]

        def walk(node, path=()):
            if isinstance(node, dict):
                return {k: walk(x, path + (k,)) for k, x in node.items()}
            node = node.clone()
            if path in (("ffm", "emb"), ("lr", "w")):
                node[rows] += torch.randn(node[rows].shape, generator=gen,
                                          device=dev) * 1e-2
            else:
                node += torch.randn(node.shape, generator=gen,
                                    device=dev) * 1e-3
            return node

        return walk(p)

    def score_while(busy):
        """(start time, ms) of each microbatch scored while ``busy()``."""
        out = []
        while busy():
            t0 = time.perf_counter()
            eng.score_batch(batches[len(out) % len(batches)])
            out.append((t0, (time.perf_counter() - t0) * 1e3))
        return out

    idle = []
    runs = {"one copy": [], "paced": []}  # per ingest: batches, copy windows
    for r in range(args.rounds):
        t_end = time.perf_counter() + IDLE_S
        idle += score_while(lambda: time.perf_counter() < t_end)
        order = ("one copy", "paced") if r % 2 == 0 else ("paced", "one copy")
        for variant in order:
            params = moved(params)
            frame = snd.make_update(params)
            T._upload_codes = timed_copy(
                paced_copy if variant == "paced" else one_copy)
            published = pipe.stats.published
            del copies[:]
            t0 = time.perf_counter()
            assert eng.submit_update(frame)
            got = score_while(lambda: pipe.stats.published == published
                              and time.perf_counter() - t0 < 120)
            wall = (time.perf_counter() - t0) * 1e3
            assert pipe.flush(timeout=600) and pipe.stats.published \
                == published + 1, f"{variant} ingest failed: {pipe.stats}"
            runs[variant].append((got, list(copies), wall))
    T._upload_codes = one_copy
    pipe.close(timeout=60)

    idle_ms = np.asarray([ms for _, ms in idle])
    p50, p99 = np.percentile(idle_ms, 50), np.percentile(idle_ms, 99)
    print(f"pacing idle: {idle_ms.size} microbatches, p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms, max {idle_ms.max():.3f} ms | {smi}")

    def describe(ms, n_ingests):
        ms = np.asarray(ms)
        if not ms.size:
            return "0 microbatches"
        return (f"{ms.size} microbatches, p50 {np.percentile(ms, 50):.3f} ms, "
                f"p99 {np.percentile(ms, 99):.3f} ms, max {ms.max():.3f} ms, "
                f"{(ms > p99).sum() / n_ingests:.1f} over the idle p99 and "
                f"{np.maximum(ms - p50, 0).sum() / n_ingests:.1f} ms over "
                f"the idle p50 per ingest")

    for variant, ingests in runs.items():
        n = len(ingests)
        whole = [ms for got, _, _ in ingests for _, ms in got]
        # microbatches whose wall time overlaps an upload of the codes
        in_copy = [ms for got, wins, _ in ingests for t, ms in got
                   if any(t < e and t + ms / 1e3 > b for b, e in wins)]
        copy_ms = [sum(e - b for b, e in wins) * 1e3 for _, wins, _ in ingests]
        walls = [w for _, _, w in ingests]
        print(f"pacing {variant}, whole ingest: {describe(whole, n)}; "
              f"submit-to-publish median {np.median(walls):.1f} ms over {n} "
              f"ingests | {smi}")
        print(f"pacing {variant}, during the copy of the codes: "
              f"{describe(in_copy, n)}; copy median {np.median(copy_ms):.1f} "
              f"ms | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
