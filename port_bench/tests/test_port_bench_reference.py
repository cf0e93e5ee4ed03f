"""The plain reference against the port on the CPU, at a tiny size: the
int8 round trip bit for bit, served logits, and three training steps."""
from __future__ import annotations

import json
import math

import numpy as np
import torch

import pb_tiny
from benchlib import traffic, weights
from benchlib.program import ffm_config
from reference import deepffm_ref as ref


def _cfg(name, **kw):
    cfg = json.loads((pb_tiny.BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(kw)
    return cfg


def test_int8_round_trip_equals_the_programs_tables():
    from repro_torch.core import quantization as Q

    cfg = _cfg("deepffm-100m", hash_space=1000)  # a partial LR block
    w = weights.make_weights(cfg, 3, "cpu")
    emb, lr = w["ffm/emb"], w["lr/w"]
    assert torch.equal(ref.dequant_rows(emb),
                       torch.from_numpy(Q.dequantize_rows(
                           Q.quantize_rows(emb.numpy()))))
    idx = torch.arange(1000)
    blocks = Q.dequantize_blocks(Q.quantize_blocks(lr.numpy(),
                                                   cfg["lr_block"]))
    assert torch.equal(ref.dequant_lr(lr, idx, cfg["lr_block"]),
                       torch.from_numpy(blocks))


def _rows(cfg, n, seed):
    rng = traffic.rng_for(seed, 9)
    idx = rng.integers(0, cfg["hash_space"], (n, cfg["n_fields"]))
    val = np.ones((n, cfg["n_fields"]), np.float32)
    val[:, -1] = rng.uniform(0.5, 2.0, n)
    return idx.astype(np.int32), val


def test_served_logits_match_the_engine():
    from repro_torch.serving.engine import InferenceEngine

    for name in ("deepffm-100m", "ffm-50m"):
        cfg = _cfg(name, hash_space=2048)
        w = weights.make_weights(cfg, 5, "cpu")
        eng = InferenceEngine(
            ffm_config(cfg), cfg["model"],
            params=weights.as_tree(w), device="cpu", quantized=True,
            fused=cfg["fused"], host_gather=False)
        idx, val = _rows(cfg, 40, 5)
        fc = cfg["context_fields"]
        reqs = [(idx[i * 10, :fc], val[i * 10, :fc],
                 idx[i * 10:(i + 1) * 10, fc:], val[i * 10:(i + 1) * 10, fc:])
                for i in range(4)]
        got = np.concatenate(eng.score_batch(reqs))
        full_idx = np.concatenate([np.concatenate(
            [np.broadcast_to(r[0], (10, fc)), r[2]], 1) for r in reqs])
        full_val = np.concatenate([np.concatenate(
            [np.broadcast_to(r[1], (10, fc)), r[3]], 1) for r in reqs])
        want = ref.serve_logits(cfg, w, full_idx, full_val)
        assert np.abs(got - want).max() < 2e-5, name
        low = ref.serve_logits(cfg, w, full_idx, full_val,
                               dtype=torch.bfloat16)
        assert np.abs(low - want).max() > 1e-3, name  # bf16 is told apart
        eng.close()


def test_three_training_steps_match_the_pipeline():
    from repro_torch.train.pipeline import TrainingPipeline

    cfg = _cfg("deepffm-100m", hash_space=2048)
    mix = dict(pb_tiny.tiny_cell("deepffm-100m.train-online").mix,
               microbatch=256)
    pool = traffic.make_train_pool(cfg, mix, 21)[:3]
    w0 = weights.make_weights(cfg, 21, "cpu")
    pipe = TrainingPipeline(ffm_config(cfg), "deepffm", "jit",
                            lr=cfg["lr"], device="cpu")
    with torch.no_grad():
        for k, t in weights.flat_leaves(pipe.params).items():
            t.copy_(w0[k])
    for mb in pool:
        pipe.run_round([mb])
    want = ref.train(cfg, w0, pool, cfg["lr"])
    for a, b in zip([r.mean_loss for r in pipe.reports], want["losses"]):
        assert math.isclose(a, b, rel_tol=1e-5)
    got = weights.flat_leaves(pipe.params)
    for k in w0:
        d_prog = float(torch.linalg.vector_norm(got[k] - w0[k]))
        d_ref = float(torch.linalg.vector_norm(want["params"][k] - w0[k]))
        assert math.isclose(d_prog, d_ref, rel_tol=1e-3, abs_tol=1e-6), k
