"""The yardstick's frozen work counts against counts made by hand, one
shape each, and the wire decoder against the program's frames."""
from __future__ import annotations

import json

import numpy as np
import torch

import pb_tiny
from benchlib import weights, wire, work


def _cfg(name):
    return json.loads((pb_tiny.BENCH / "configs" / f"{name}.json").read_text())


def test_k1_by_hand():
    # 10 rows of 96 int8 codes: a multiply and an add a code; codes, the
    # index and two f32 grid scalars read, f32 rows written
    assert work.k1_work(10, 96) == (2 * 960, 10 * (96 + 4 + 8) + 960 * 4)


def test_k3_by_hand():
    # 1 row x 2 candidates, Fc 16, Fcand 8, k 4: 2 x (16*8 + 8*8) = 384
    # dot entries of 2k + 2 = 10 operations, and 2 x 8 candidate rows of
    # 24 x 4 codes dequantized (2 operations each)
    flops, nbytes = work.k3_work(1, 2, 16, 8, 4)
    assert flops == 384 * 10 + 16 * 96 * 2
    ctx = (16 * 8 * 4 + 16) * 4 + 16 * 4
    assert nbytes == ctx + 16 * (96 + 8) + 384 * 4


def test_k5_by_hand():
    r, n, fc, fcand, k = 1, 1, 16, 8, 8
    flops, nbytes = work.k5_work(r, n, fc, fcand, k)
    n_aa = 28
    per_cand = 16 * 8 * (2 * k + 3 + k + 3) + n_aa * (2 * k + 3 + 4 * k + 10) + 3
    assert flops == 16 * 16 * (2 * k + 3) + per_cand
    io = (16 * 24 * 8 + 16 + 1 + 256) * 4 + 8 + 8 * 4
    assert nbytes == io + 8 * (24 * 8 + 8)


def test_head_and_row_counts_by_hand():
    cfg = _cfg("deepffm-100m")
    f, b = work.head_work(cfg, 3)
    assert f == 3 * 2 * (277 * 64 + 64 * 32 + 32 * 1)
    assert b == 3 * 4 * (277 + 64 + 64 + 32 + 32 + 1)
    # about 42 kFLOP a scored row: K3's row plus the head
    assert 38_000 < work.serve_row_flops(cfg) < 46_000
    assert work.head_work(_cfg("ffm-50m"), 3) == (0, 0)
    assert work.bound_seconds(67e12, 0) == 1.0
    assert work.bound_seconds(0, 3.35e12) == 1.0


def test_work_copies_equal_the_programs_bookings():
    from repro_torch.kernels.ffm_interaction import ops as fo
    from repro_torch.kernels.row_gather import ops as ro

    assert work.k1_work(37, 96) == ro.k1_work(37, 96)
    assert work.k3_work(4, 64, 16, 8, 4) == fo.k3_work(4, 64, 16, 8, 4)
    assert work.k5_work(4, 64, 16, 8, 8) == fo.k5_work(4, 64, 16, 8, 8)


def test_wire_decoder_follows_the_programs_frames():
    from repro_torch.checkpoint import transfer

    cfg = dict(_cfg("deepffm-100m"), hash_space=512)
    w = weights.make_weights(cfg, 7, "cpu")
    tree = weights.as_tree({k: t.clone() for k, t in w.items()})
    snd = transfer.Sender(mode="patch+quant", device="cpu")
    dec = wire.Decoder()
    dec.apply(snd.make_update(tree))
    rows = np.array([3, 17, 200])
    tree["ffm"]["emb"][rows] += 0.01
    tree["lr"]["w"][rows] -= 0.02
    tree["mlp"]["w0"] += 0.001
    dec.apply(snd.make_update(tree, touched={"ffm/emb": rows,
                                             "lr/w": rows}))
    got = wire.split_leaves(dec.weights(), weights.leaf_shapes(cfg))
    for k, t in weights.flat_leaves(tree).items():
        # half a bucket, and the f32 roundings of code and reconstruction
        assert np.abs(got[k] - t.numpy()).max() <= 0.51 * dec.bucket


def test_weights_are_a_function_of_the_seed():
    cfg = dict(_cfg("deepffm-100m"), hash_space=256)
    a = weights.make_weights(cfg, 2**35, "cpu")
    b = weights.make_weights(cfg, 2**35, "cpu")
    c = weights.make_weights(cfg, 2**35 + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ffm/emb"], c["ffm/emb"])
    assert set(a) == set(weights.leaf_shapes(cfg))
    assert float(a["mlp/w2"].abs().sum()) > 0  # the head is not silent
