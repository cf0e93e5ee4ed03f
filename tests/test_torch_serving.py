"""Port serving engine against the JAX engine on the CPU.

``repro_torch.serving.engine.InferenceEngine(device="cpu")`` and
``repro.serving.engine.InferenceEngine`` serve the same weights; for the
``ffm``/``deepffm`` heads, f32/int8 tables and both backends (the port's
``"cuda"`` runs its kernels' plain versions here and stands against JAX's
``"pallas"``), the two must return the same scores (rtol 2e-4, atol 2e-5,
as ``test_quantized_serving.py``) and the same cache and dedup counters.
"""
import jax
import numpy as np
import pytest
import torch

from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as jdeepffm
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.engine import compute_context as j_compute_context
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.serving.engine import (InferenceEngine, ScoringPlan,
                                       compute_context)
from repro_torch.serving.prefix_cache import PrefixCache, context_tokens

CFG = FFMConfig(n_fields=8, context_fields=5, hash_space=2**10, k=4,
                mlp_hidden=(16, 8))
JCFG = JFFMConfig(**CFG.__dict__)
FCAND = CFG.n_fields - CFG.context_fields
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _pinned_gather_cliff(monkeypatch):
    # the JAX package's int8 gather consults a per-process calibration probe
    # of its host gather; pin its constant so the reference runs no probe
    monkeypatch.setenv("REPRO_CLIFF_CALIBRATE", "0")


def _np_params(model: str, seed: int = 0):
    params = jax.tree_util.tree_map(
        np.asarray, jdeepffm.init_params(JCFG, jax.random.PRNGKey(seed), model))
    rng = np.random.default_rng(seed + 1)
    params["lr"]["w"] = rng.normal(0, 0.1, CFG.hash_space).astype(np.float32)
    params["ffm"]["emb"] = rng.normal(
        0, 0.3, params["ffm"]["emb"].shape).astype(np.float32)
    if "mlp" in params:
        last = f"w{len(CFG.mlp_hidden)}"
        params["mlp"][last] = rng.normal(
            0, 0.5, params["mlp"][last].shape).astype(np.float32)
    return params


def _request(rng, n, ctx=None):
    ci = (rng.integers(0, CFG.hash_space, CFG.context_fields).astype(np.int32)
          if ctx is None else ctx)
    cv = np.ones(CFG.context_fields, np.float32)
    ki = rng.integers(0, CFG.hash_space, (n, FCAND)).astype(np.int32)
    kv = rng.uniform(0.5, 2.0, (n, FCAND)).astype(np.float32)
    return ci, cv, ki, kv


def _engines(model, quantized, backend, **kw):
    params = _np_params(model)
    port = InferenceEngine(CFG, model, backend=backend, device="cpu",
                           params=params_from_numpy(params, "cpu"),
                           quantized=quantized, **kw)
    ref = JEngine(JCFG, model, backend={"cuda": "pallas"}.get(backend, backend),
                  params=params, quantized=quantized, host_gather=False,
                  parallel=1, **kw)
    return port, ref


@pytest.mark.parametrize("model", ["ffm", "deepffm"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_engine_matches_jax_engine(model, quantized, backend):
    port, ref = _engines(model, quantized, backend)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, CFG.hash_space, CFG.context_fields).astype(np.int32)
    # one request per slate size (every candidate bucket, ragged and exact),
    # half of them on a shared context so later ones hit the cache
    for i, n in enumerate((1, 7, 8, 9, 16, 31, 32)):
        req = _request(rng, n, shared if i % 2 else None)
        got, want = port.score(*req), np.asarray(ref.score(*req))
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)
        for use_backend in (False, True):
            np.testing.assert_allclose(
                port.score_uncached(*req, use_backend=use_backend).numpy(),
                np.asarray(ref.score_uncached(*req, use_backend=use_backend)),
                **TOL)
    # a microbatch: repeated and prefix-sharing contexts, duplicated
    # candidates across requests of one context, an empty slate
    base = _request(rng, 12)
    prefix_mate = base[0].copy()
    prefix_mate[4:] = rng.integers(0, CFG.hash_space, 1)
    batch = [base,
             (base[0], base[1], base[2][:5], base[3][:5]),        # dedup
             (base[0], base[1], np.zeros(0, np.int32), np.zeros(0, np.float32)),
             _request(rng, 9, prefix_mate),                       # depth-4 hit
             _request(rng, 20, shared)]                           # full hit
    got = port.score_batch(batch)
    want = ref.score_batch(batch)
    assert [g.shape for g in got] == [np.asarray(w).shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    assert (port.hits, port.misses) == (ref.hits, ref.misses)
    for key in ("requests", "candidates", "rows_scored", "ctx_partials_full",
                "ctx_tail_fields"):
        assert getattr(port.stats, key) == getattr(ref.stats, key), key
    assert port.stats.dedup_saved == ref.stats.dedup_saved > 0
    assert port.cache_hit_rate == ref.cache_hit_rate
    assert port.score_batch([]) == []


@pytest.mark.parametrize("dedup,prefix_stride", [(False, 4), (True, None),
                                                 (True, 2)])
def test_engine_options_match_jax_engine(dedup, prefix_stride):
    """No-dedup layout and other checkpoint strides give the same scores and
    counters as the JAX engine, and warmup runs the same bucket grid."""
    port, ref = _engines("deepffm", True, "cuda", dedup=dedup,
                         prefix_stride=prefix_stride)
    assert port.warmup(max_requests=4, max_candidates=16) == \
        ref.warmup(max_requests=4, max_candidates=16)
    rng = np.random.default_rng(5)
    base = _request(rng, 6)
    batch = [base, (base[0], base[1], base[2][:3], base[3][:3]),
             _request(rng, 11), _request(rng, 4, base[0])]
    for _ in range(2):  # second round: full-depth hits
        for g, w in zip(port.score_batch(batch), ref.score_batch(batch)):
            np.testing.assert_allclose(g, np.asarray(w), **TOL)
    assert (port.hits, port.misses) == (ref.hits, ref.misses)
    assert port.stats.rows_scored == ref.stats.rows_scored
    assert port.stats.ctx_tail_fields == ref.stats.ctx_tail_fields


@pytest.mark.parametrize("quantized", [False, True])
def test_compute_context_matches_jax(quantized):
    """The full-depth context partial (prefix-state format) on both sides."""
    from repro.core import quantization as JQ

    params = _np_params("ffm")
    if quantized:
        params = JQ.quantize_params_rows(params)
    ci, cv, _, _ = _request(np.random.default_rng(4), 1)
    want = j_compute_context(JCFG, jax.tree_util.tree_map(np.asarray, params),
                             ci, cv)
    got = compute_context(CFG, params_from_numpy(params, "cpu"),
                          torch.from_numpy(ci), torch.from_numpy(cv))
    for key in ("emb", "val", "pairs", "lr_terms"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6)


def test_install_params_bumps_generation_and_rescores():
    params = _np_params("deepffm")
    eng = InferenceEngine(CFG, device="cpu", quantized=True)
    with pytest.raises(RuntimeError):
        eng.score(*_request(np.random.default_rng(0), 3))
    eng.install_params(params_from_numpy(params, "cpu"))
    req = _request(np.random.default_rng(1), 5)
    first = eng.score(*req)
    assert eng.generation == 1
    params["ffm"]["emb"] = params["ffm"]["emb"] * 2.0
    eng.install_params(params_from_numpy(params, "cpu"))
    assert eng.generation == 2
    # the cached context partial is stamped with generation 1 and recomputed
    second = eng.score(*req)
    np.testing.assert_allclose(second, eng.score_uncached(*req).numpy(), **TOL)
    assert not np.allclose(second, first, **TOL)
    f32 = InferenceEngine(CFG, device="cpu",
                          params=params_from_numpy(params, "cpu"))
    assert 3.0 < f32.resident_weight_bytes / eng.resident_weight_bytes < 4.0


def test_engine_rejects_malformed_requests():
    params = params_from_numpy(_np_params("ffm"), "cpu")
    eng = InferenceEngine(CFG, "ffm", device="cpu", params=params)
    rng = np.random.default_rng(2)
    ci, cv, ki, kv = _request(rng, 4)
    bad = ki.copy()
    bad[1, 0] = CFG.hash_space
    with pytest.raises(ValueError):
        eng.score(ci, cv, bad, kv)
    with pytest.raises(ValueError):
        eng.score_uncached(ci, cv, -bad, kv)
    with pytest.raises(ValueError):
        eng.score(ci, cv, ki.reshape(-1), kv.reshape(-1))
    with pytest.raises(ValueError):
        InferenceEngine(CFG, "ffm", device="cpu", backend="pallas")


def test_prefix_cache_matches_jax():
    """Same inserts and lookups give the same hit depths, LRU order and
    eviction in both tries; evicted states truncate to the shared depth."""
    fc = CFG.context_fields
    rng = np.random.default_rng(9)
    ours, theirs = PrefixCache(fc, max_entries=3, stride=2), \
        JPrefixCache(fc, max_entries=3, stride=2)
    base = rng.integers(0, 50, fc).astype(np.int32)
    vals = np.ones(fc, np.float32)
    keys = []
    for i in range(6):
        ci = base.copy()
        ci[2 * (i % 3):] = rng.integers(0, 50, fc - 2 * (i % 3))
        keys.append(context_tokens(ci, vals))
    state = {"emb": torch.arange(fc * 2.0).reshape(fc, 2),
             "val": torch.ones(fc), "pairs": torch.arange(fc * (fc - 1) / 2),
             "lr_terms": torch.zeros(fc)}
    nstate = {k: v.numpy() for k, v in state.items()}
    for gen, key in enumerate(keys):
        assert ours.lookup(key, 0)[0] == theirs.lookup(key, 0)[0]
        ours.insert(key, 0, state)
        theirs.insert(key, 0, nstate)
        assert ours.keys() == theirs.keys()
    assert ours.checkpoint_depths() == theirs.checkpoint_depths()
    assert ours.tail_lengths() == theirs.tail_lengths()
    for key in keys:
        (d1, s1), (d2, s2) = ours.lookup(key, 0), theirs.lookup(key, 0)
        assert d1 == d2
        if s1 is not None:
            assert {k: tuple(v.shape) for k, v in s1.items()} == \
                {k: v.shape for k, v in s2.items()}


def test_scoring_plan_buckets():
    plan = ScoringPlan(CFG, min_bucket=8)
    assert [plan.bucket(n) for n in (1, 8, 9, 33)] == [8, 8, 16, 64]
    assert plan.buckets_upto(64) == [8, 16, 32, 64]
    assert plan.buckets_upto(5, minimum=1) == [1, 2, 4, 8]
