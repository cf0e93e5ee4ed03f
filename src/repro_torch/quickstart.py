"""Quickstart: the paper's production loop in one script (the port's twin of
``examples/quickstart.py``).

Train a DeepFFM online -> ship versioned quantized byte patches to a
long-lived serving engine (hot weight swaps, context cache and candidate
kernels composed) -> serve candidate requests, microbatched. Run with::

    PYTHONPATH=src python -m repro_torch.quickstart               # the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu  # plain versions
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint import transfer
from repro_torch.common.config import FFMConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.metrics import roc_auc
from repro_torch.core import deepffm
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.synthetic import CTRStream
from repro_torch.serving.engine import InferenceEngine
from repro_torch.train.pipeline import (_batch_tensors, _flat,
                                        _leaves_requiring_grad)

CFG = FFMConfig(n_fields=12, context_fields=8, hash_space=2**14, k=4,
                mlp_hidden=(16, 8))
ROUNDS, BATCHES, BATCH = 3, 30, 512  # online rounds of prefetched batches
LR, EPS = 0.1, 1e-10                 # the hand AdaGrad of the JAX example


def main(device: DeviceLike = None) -> Dict[str, Any]:
    """Run the loop on ``device`` (``None``: the card) and return what it
    printed: per-round loss, update bytes and weights version, the served
    model's AUC and the microbatch latency percentiles."""
    dev = resolve_device(device)
    stream = CTRStream(CFG, seed=7)

    # --- trainer ------------------------------------------------------------
    params = deepffm.init_params(CFG, 0, "deepffm", dev)
    leaves = _flat(params)
    acc = [torch.zeros_like(t) for t in leaves]
    sender = transfer.Sender(mode="patch+quant", device=dev)  # paper §6
    # one long-lived serving instance: §5 context cache + candidate kernels
    engine = InferenceEngine(CFG, device=dev)

    rounds = []
    for round_ in range(ROUNDS):  # online training rounds (paper: every ~5 min)
        for batch in Prefetcher(stream.batches(BATCH, BATCHES), depth=4):
            var = _leaves_requiring_grad(params)
            loss = deepffm.loss_fn(CFG, var, _batch_tensors(batch, dev))
            grads = torch.autograd.grad(loss, _flat(var))
            with torch.no_grad():
                for p, a, g in zip(leaves, acc, grads):
                    a.add_(g * g)
                    p.sub_(LR * g / torch.sqrt(a + EPS))
        update = sender.make_update(params)
        # hot swap: weights change in place, the context cache survives
        engine.apply_update(update, sender.manifest, like_params=params)
        ctx_i, ctx_v, cand_i, cand_v = stream.request(n_candidates=16)
        scores = engine.score(ctx_i, ctx_v, cand_i, cand_v)
        rounds.append({"loss": float(loss.detach()), "update_bytes": len(update),
                       "weights_version": engine.weights_version,
                       "best": int(np.argmax(scores)), "hits": engine.hits,
                       "misses": engine.misses})
        r = rounds[-1]
        print(f"round {round_}: loss={r['loss']:.4f} update="
              f"{r['update_bytes']:,} bytes (weights v{r['weights_version']})")
        print(f"  request: best candidate {r['best']}, cache hits={r['hits']} "
              f"misses={r['misses']}")

    # --- serving ------------------------------------------------------------
    test = stream.sample(4096)
    with torch.no_grad():
        probs = deepffm.predict_proba(
            CFG, engine.params, torch.from_numpy(test["idx"]).to(dev),
            torch.from_numpy(test["val"]).to(dev)).cpu().numpy()
    auc = roc_auc(test["label"], probs)
    print(f"served-model AUC: {auc:.4f}")

    # microbatched requests: one forward, power-of-two padding buckets
    requests = [stream.request(n_candidates=n) for n in (16, 5, 16, 9)]
    batched = [int(np.argmax(s)) for s in engine.score_batch(requests)]
    for best in batched:
        print(f"batched request: best candidate {best}")
    st = engine.stats
    print(f"latency p50={st.p50_ms:.2f}ms p99={st.p99_ms:.2f}ms "
          f"({st.predictions_per_s:.0f} preds/s)")
    engine.update_pipe().close()
    return {"rounds": rounds, "auc": auc, "batched_best": batched,
            "weights_version": engine.weights_version, "p50_ms": st.p50_ms,
            "p99_ms": st.p99_ms, "predictions_per_s": st.predictions_per_s}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    main(ap.parse_args().device)
