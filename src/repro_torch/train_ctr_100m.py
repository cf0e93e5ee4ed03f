"""Train a ~100M-parameter DeepFFM for a few hundred steps (the port's twin
of ``examples/train_ctr_100m.py``).

hash_space 2^20 x 24 fields x k=4 -> 100.7M FFM weights (+ LR + MLP head),
the production-CTR scale the paper operates at. Shows the prefetched data
pipeline, the dense AdaGrad loop or Hogwild multi-thread training (§4.2),
both with the §4.3 backward (kernel K10 for the hidden layers' weight
gradients), checkpointing, and what one online update costs on the
quantized transfer channel (§6; kernels K7 and K8). Run with::

    PYTHONPATH=src python -m repro_torch.train_ctr_100m            # the card
    PYTHONPATH=src python -m repro_torch.train_ctr_100m --hogwild
    PYTHONPATH=src python -m repro_torch.train_ctr_100m --device cpu --steps 5
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store, transfer
from repro_torch.common.config import FFMConfig
from repro_torch.common.device import (DeviceLike, resolve_device,
                                       synchronize)
from repro_torch.common.metrics import roc_auc
from repro_torch.core import deepffm
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.synthetic import CTRStream
from repro_torch.train.hogwild import HogwildTrainer
from repro_torch.train.pipeline import (_batch_tensors, _flat,
                                        _leaves_requiring_grad, _unflat)

CFG = FFMConfig(n_fields=24, context_fields=16, hash_space=2**20, k=4,
                mlp_hidden=(64, 32))
LR, EPS = 0.1, 1e-10  # the example's hand AdaGrad
DEPTH = 8             # prefetched batches
TEST_ROWS = 8192
DRIFT, DRIFT_SHARE = 1e-5, 0.01  # the second update: 1% of weights moved


def dense_step(cfg: FFMConfig, params, acc, batch) -> torch.Tensor:
    """One step of the example's dense loop on ``batch`` (tensors): the loss
    under autograd (the §4.3 backward), then AdaGrad on ``params`` and its
    accumulator ``acc`` (a tree of the same shape), in place. Returns the
    loss."""
    var = _leaves_requiring_grad(params)
    loss = deepffm.loss_fn(cfg, var, batch)
    grads = torch.autograd.grad(loss, _flat(var))
    with torch.no_grad():
        for p, a, g in zip(_flat(params), _flat(acc), grads):
            a.add_(g * g)
            p.sub_(LR * g / torch.sqrt(a + EPS))
    return loss.detach()


def drift(params):
    """The example's second update: ``1e-5`` added in f32 to the weights a
    fresh ``np.random.default_rng(0)`` picks per leaf (1% of them)."""
    def leaf(x):
        mask = np.random.default_rng(0).random(tuple(x.shape)) < DRIFT_SHARE
        step = torch.from_numpy(np.asarray(DRIFT * mask, np.float32))
        return x + step.to(x.device)
    return _unflat(params, iter(leaf(x) for x in _flat(params)))


def run(cfg: FFMConfig = CFG, steps: int = 200, batch: int = 512,
        hogwild: bool = False, threads: int = 4, ckpt: Optional[str] = None,
        device: DeviceLike = None, params=None) -> Dict[str, Any]:
    """Train ``steps`` batches of ``batch`` on one route, then evaluate,
    checkpoint to ``ckpt`` and frame two updates. ``params``: the dense
    route's start (default: ``init_params(cfg, 0)``); the Hogwild route
    starts from ``HogwildTrainer``'s own. Returns what it printed, the
    trained params, the two frames and, on the card, the steps' device
    memory peak (bytes)."""
    dev = resolve_device(device)
    ckpt = ckpt or os.path.join(tempfile.gettempdir(), "repro_torch_ctr_100m")
    n = cfg.hash_space * cfg.n_fields * cfg.k + cfg.hash_space  # FFM + LR
    print(f"DeepFFM with {n / 1e6:.1f}M parameters")
    stream = CTRStream(cfg, seed=0)
    batches = Prefetcher(stream.batches(batch, steps), depth=DEPTH)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    synchronize(dev)
    t0 = time.perf_counter()
    if hogwild:
        trainer = HogwildTrainer(cfg, lr=LR, device=dev)
        stats = trainer.train(batches, n_threads=threads)
        params, losses, examples = trainer.params(), stats.losses, stats.examples
        print(f"hogwild: {stats.examples} examples at "
              f"{stats.examples_per_s:.0f}/s across {threads} threads")
    else:
        if params is None:
            params = deepffm.init_params(cfg, 0, "deepffm", dev)
        acc = _unflat(params, iter(torch.zeros_like(t) for t in _flat(params)))
        losses, examples = [], 0
        for i, b in enumerate(batches):
            loss = dense_step(cfg, params, acc, _batch_tensors(b, dev))
            losses.append(loss)
            examples += len(b["label"])
            if i % 50 == 0:
                print(f"step {i}: loss {float(loss):.4f}")
        losses = [float(x) for x in losses]
    synchronize(dev)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    print(f"trained in {train_s:.1f}s ({examples / train_s:.0f} examples/s)"
          + ("" if peak is None else
             f"; device memory peak {peak / 2**30:.2f} GiB"))

    test = stream.sample(TEST_ROWS)
    with torch.no_grad():
        probs = deepffm.predict_proba(
            cfg, params, torch.from_numpy(test["idx"]).to(dev),
            torch.from_numpy(test["val"]).to(dev)).cpu().numpy()
    auc = roc_auc(test["label"], probs)
    print(f"test AUC: {auc:.4f}")

    # checkpoint (weights; optimizer state would go to its own file, §6)
    store.save(ckpt, params)
    print(f"checkpointed to {ckpt}")

    # what one online update would cost to ship
    sender = transfer.Sender(mode="patch+quant", device=dev)
    full = sender.make_update(params)
    t0 = time.perf_counter()
    update = sender.make_update(drift(params))
    patch_s = time.perf_counter() - t0
    print(f"patch+quant online update: {len(update):,} bytes "
          f"({len(update) / (n * 4):.2%} of raw) in {patch_s:.1f}s")
    return {"n_params": n, "params": params, "losses": losses,
            "examples": examples, "train_s": train_s,
            "examples_per_s": examples / train_s, "peak_bytes": peak,
            "auc": auc, "ckpt": ckpt, "frames": (full, update),
            "patch_s": patch_s}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--hogwild", action="store_true")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: repro_torch_ctr_100m "
                         "in the temporary directory)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return run(CFG, args.steps, args.batch, args.hogwild, args.threads,
               args.ckpt, args.device)


if __name__ == "__main__":
    main()
