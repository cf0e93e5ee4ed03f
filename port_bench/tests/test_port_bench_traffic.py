"""The traffic generator: one seed, one pool, bit for bit; the mix's
parameters hold in what it makes."""
from __future__ import annotations

import numpy as np
import pytest

import pb_tiny
from benchlib import traffic


def _serve(name, seed):
    cell = pb_tiny.tiny_cell(name)
    return cell, traffic.make_serve_pool(cell.config, cell.mix, seed)


def _flat(pool):
    return [tuple(np.ascontiguousarray(x).tobytes() for x in r)
            for call in pool.calls + pool.warmup for r in call]


SERVE = [n for n in pb_tiny.CELLS if "serve" in n]


@pytest.mark.parametrize("name", SERVE)
def test_serve_pool_is_a_function_of_the_seed(name):
    _, a = _serve(name, pb_tiny.SEED)
    _, b = _serve(name, pb_tiny.SEED)
    _, c = _serve(name, pb_tiny.SEED + 1)
    assert _flat(a) == _flat(b)
    assert _flat(a) != _flat(c)


def test_train_pool_is_a_function_of_the_seed():
    cell = pb_tiny.tiny_cell("deepffm-100m.train-online")
    a = traffic.make_train_pool(cell.config, cell.mix, 2**40 + 3)
    b = traffic.make_train_pool(cell.config, cell.mix, 2**40 + 3)
    c = traffic.make_train_pool(cell.config, cell.mix, 2**40 + 4)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["idx"], c[0]["idx"])
    assert len(a) == cell.mix["pool_microbatches"]
    assert a[0]["idx"].shape == (cell.mix["microbatch"],
                                 cell.config["n_fields"])
    labels = np.concatenate([m["label"] for m in a])
    assert 0.05 < labels.mean() < 0.95


def test_serve_pool_keeps_to_its_mix():
    cell, pool = _serve("deepffm-100m.serve-slates", pb_tiny.SEED)
    m, c = cell.mix, cell.config
    fc, f = c["context_fields"], c["n_fields"]
    lo, hi = m["candidates"]["lo"], m["candidates"]["hi"]
    for call in pool.calls + pool.warmup:
        assert len(call) == m["requests_per_call"]
        for ci, cv, ki, kv in call:
            assert ci.shape == (fc,) and ki.shape[1] == f - fc
            assert lo <= ki.shape[0] <= hi and kv.shape == ki.shape
            assert np.all(cv == 1.0) and np.all(kv == 1.0)
            assert 0 <= min(ci.min(), ki.min())
            assert max(ci.max(), ki.max()) < c["hash_space"]
    assert len(pool.calls) == m["pool_calls"]


def test_every_call_holds_the_same_sizes():
    """A seed changes which rows come, never how much work a call is."""
    cell, pool = _serve("ffm-50m.serve-fused", pb_tiny.SEED)
    _, other = _serve("ffm-50m.serve-fused", pb_tiny.SEED + 7)
    want = sorted(r[2].shape[0] for r in pool.calls[0])
    for call in pool.calls + other.calls:
        assert sorted(r[2].shape[0] for r in call) == want
    assert len({tuple(r[2].shape[0] for r in call)
                for call in pool.calls}) > 1  # in an order of the seed's


def test_each_field_draws_from_its_own_vocabulary():
    cell = pb_tiny.tiny_cell("deepffm-100m.train-online")
    pool = traffic.make_train_pool(cell.config, cell.mix, pb_tiny.SEED)
    idx = np.concatenate([m["idx"] for m in pool])
    vocab = cell.mix["values_per_field"]
    for j, v in enumerate(vocab):
        seen = np.unique(idx[:, j])
        assert 1 < seen.size <= v
        if v <= 30:  # a small vocabulary is drawn whole
            assert seen.size >= v // 2
    # a heavy head: the commonest value of the largest field
    j = int(np.argmax(vocab))
    _, counts = np.unique(idx[:, j], return_counts=True)
    assert counts.max() > 10 * idx.shape[0] / vocab[j]


def test_zipf_is_heavy_headed_and_bounded():
    z = traffic.Zipf(1000, 1.1)
    rng = traffic.rng_for(5, 0)
    r = z.draw(rng, 200_000)
    assert r.min() >= 0 and r.max() < 1000
    share0 = np.mean(r == 0)
    want = 1.0 / np.sum(np.arange(1, 1001, dtype=float) ** -1.1)
    assert abs(share0 - want) < 0.01


def test_feature_hash_matches_the_program():
    from repro_torch.data.synthetic import feature_hash

    f = np.arange(24)[None, :].repeat(50, 0)
    v = traffic.rng_for(1, 2).integers(0, 10**6, (50, 24))
    assert np.array_equal(traffic.feature_hash(f, v, 2**20),
                          feature_hash(f, v, 2**20))
