"""The port's fused scoring path against the JAX package on the CPU.

On CPU tensors the fused wrappers (``ffm_fused_logits_q8``/``_rows``) run
their plain versions; these tests hold them to the Pallas kernels in
interpret mode (rtol 1e-5, atol 1e-5, as ``test_kernels.py``), the fused
context-state functions to the JAX ``_np`` versions, and a fused
``InferenceEngine(device="cpu")`` both to the JAX fused engine and to the
port's own staged engine, within ``quantization.fused_logit_tolerance`` (as
``test_fused_scoring.py``), with the same cache and dedup counters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as jdeepffm
from repro.core import ffm as jffm
from repro.core import quantization as JQ
from repro.kernels.ffm_interaction import ops as j_ops
from repro.kernels.ffm_interaction.ffm_interaction import (
    ffm_fused_logits_q8, ffm_fused_logits_rows)
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import ffm
from repro_torch.core import quantization as Q
from repro_torch.kernels.ffm_interaction import ops as t_ops
from repro_torch.serving.engine import InferenceEngine, ScoringPlan

CFG = FFMConfig(n_fields=8, context_fields=5, hash_space=2**10, k=4,
                mlp_hidden=(16, 8))
JCFG = JFFMConfig(**CFG.__dict__)
FC, FCAND = CFG.context_fields, CFG.n_fields - CFG.context_fields
# test_fused_scoring.py's configuration, for the port-only engine tests
CFG12 = FFMConfig(n_fields=12, context_fields=8, hash_space=2**13, k=4,
                  mlp_hidden=(16,))


@pytest.fixture(autouse=True)
def _pinned_gather_cliff(monkeypatch):
    # the JAX package's host gather consults a per-process calibration probe;
    # pin its constant so the reference runs no probe
    monkeypatch.setenv("REPRO_CLIFF_CALIBRATE", "0")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fused_inputs(rng, R, Fc, Fcand, K, N):
    F = Fc + Fcand
    return dict(
        ectx=rng.normal(0, 0.3, (R, Fc, F, K)).astype(np.float32),
        vctx=rng.normal(1, 0.25, (R, Fc)).astype(np.float32),
        depth=rng.integers(0, Fc + 1, R).astype(np.int32),
        base=rng.normal(0, 0.5, (R, N)).astype(np.float32),
        qcx=rng.integers(-127, 128, (R, N, Fcand, Fc, K)).astype(np.int8),
        qcc=rng.integers(-127, 128, (R, N, Fcand, Fcand, K)).astype(np.int8),
        scale=rng.uniform(1e-3, 5e-3, (R, N, Fcand)).astype(np.float32),
        zero=rng.normal(0, 0.05, (R, N, Fcand)).astype(np.float32),
        ecx=rng.normal(0, 0.3, (R, N, Fcand, Fc, K)).astype(np.float32),
        ecc=rng.normal(0, 0.3, (R, N, Fcand, Fcand, K)).astype(np.float32),
        vcand=rng.normal(1, 0.25, (R, N, Fcand)).astype(np.float32),
    )


_Q8_KEYS = ("ectx", "vctx", "depth", "base", "qcx", "qcc", "scale", "zero",
            "vcand")
_ROWS_KEYS = ("ectx", "vctx", "depth", "base", "ecx", "ecc", "vcand")


@pytest.mark.parametrize("R,Fc,Fcand,K,N,block_n", [
    (1, 4, 2, 2, 3, 4),     # single row, candidate pad (3 -> 4) in Pallas
    (4, 8, 4, 4, 10, 4),    # multi-tile candidate axis with ragged pad
    (3, 6, 6, 8, 16, 16),   # tile == bucket (no pad)
    (1, 64, 64, 8, 3, 4),   # F = 128: past the ctx x ctx, ctx x cand and
                            # cand x cand register slots of the CUDA body
])
@pytest.mark.parametrize("quantized", [True, False])
def test_fused_logits_match_pallas(R, Fc, Fcand, K, N, block_n, quantized):
    """Logits and the readback ctx pair matrix, across tiling/padding shapes
    and mixed cached-prefix depths (test_kernels.py's sweep)."""
    a = _fused_inputs(np.random.default_rng(R * 100 + N), R, Fc, Fcand, K, N)
    keys = _Q8_KEYS if quantized else _ROWS_KEYS
    pallas = ffm_fused_logits_q8 if quantized else ffm_fused_logits_rows
    port = t_ops.ffm_fused_logits_q8 if quantized else t_ops.ffm_fused_logits_rows
    want, want_d = pallas(*[jnp.asarray(a[k]) for k in keys], block_n=block_n)
    got, got_d = port(*[_t(a[k]) for k in keys])
    assert got.shape == (R, N) and got_d.shape == (R, Fc, Fc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [True, False])
def test_fused_padding_is_inert(quantized):
    """Zero-padded candidate slots (s = z = v = 0) leave the real slots'
    logits bit-identical, and those equal the logits scored at the unpadded
    N (to 1e-6: torch's CPU reductions may reorder with N; the kernels'
    bit-invariance across buckets is checked on the card by chip_smoke.py);
    a row with no candidates still returns its ctx pair matrix."""
    a = _fused_inputs(np.random.default_rng(3), 2, 4, 4, 4, 8)
    keys = _Q8_KEYS if quantized else _ROWS_KEYS
    fn = t_ops.ffm_fused_logits_q8 if quantized else t_ops.ffm_fused_logits_rows
    per_cand = {"base", "qcx", "qcc", "scale", "zero", "ecx", "ecc", "vcand"}

    def cut(k, n):
        return a[k][:, :n] if k in per_cand else a[k]

    def padded(k):
        if k not in per_cand or k == "base":
            return a[k]
        x = a[k].copy()
        x[:, 5:] = 0
        return x

    full, full_d = fn(*[_t(a[k]) for k in keys])
    short, short_d = fn(*[_t(cut(k, 5)) for k in keys])
    pad, _ = fn(*[_t(padded(k)) for k in keys])
    np.testing.assert_array_equal(pad.numpy()[:, :5], full.numpy()[:, :5])
    np.testing.assert_allclose(short.numpy(), full.numpy()[:, :5],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(short_d.numpy(), full_d.numpy())
    empty, empty_d = fn(*[_t(cut(k, 0)) for k in keys])
    assert empty.shape == (2, 0)
    np.testing.assert_array_equal(empty_d.numpy(), full_d.numpy())


@pytest.mark.parametrize("quantized", [True, False])
def test_fused_candidate_logits_match_jax_ops(quantized):
    """The cfg-level ops split one gathered block into its context and
    candidate column halves (views) exactly as the JAX ops do."""
    rng = np.random.default_rng(11)
    R, N = 3, 9
    a = _fused_inputs(rng, R, FC, FCAND, CFG.k, N)
    if quantized:
        blk = rng.integers(-127, 128, (R, N, FCAND, CFG.n_fields, CFG.k)
                           ).astype(np.int8)
        want = j_ops.fused_candidate_logits_q8(
            JCFG, a["ectx"], a["vctx"], a["depth"], a["base"], blk,
            a["scale"], a["zero"], a["vcand"])
        got = t_ops.fused_candidate_logits_q8(
            CFG, _t(a["ectx"]), _t(a["vctx"]), _t(a["depth"]), _t(a["base"]),
            _t(blk), _t(a["scale"]), _t(a["zero"]), _t(a["vcand"]))
    else:
        blk = rng.normal(0, 0.3, (R, N, FCAND, CFG.n_fields, CFG.k)
                         ).astype(np.float32)
        want = j_ops.fused_candidate_logits_rows(
            JCFG, a["ectx"], a["vctx"], a["depth"], a["base"], blk,
            a["vcand"])
        got = t_ops.fused_candidate_logits_rows(
            CFG, _t(a["ectx"]), _t(a["vctx"]), _t(a["depth"]), _t(a["base"]),
            _t(blk), _t(a["vcand"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def _np_params(model: str = "ffm", seed: int = 0, cfg=CFG):
    jcfg = JFFMConfig(**cfg.__dict__)
    params = jax.tree_util.tree_map(
        np.asarray, jdeepffm.init_params(jcfg, jax.random.PRNGKey(seed), model))
    rng = np.random.default_rng(seed + 1)
    params["lr"]["w"] = rng.normal(0, 0.1, cfg.hash_space).astype(np.float32)
    params["ffm"]["emb"] = rng.normal(
        0, 0.3, params["ffm"]["emb"].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("depth", [0, 2, 4])
def test_fused_context_state_matches_jax(quantized, depth):
    """``fused_context_state`` from a depth-p prefix and the full-depth state
    ``prefix_state_from_dots`` rebuilds from a pair matrix, against the JAX
    ``_np`` versions; the rebuilt state also equals the staged extension."""
    params = _np_params()
    if quantized:
        params = JQ.quantize_params_rows(params)
    tparams = params_from_numpy(params, "cpu")
    emb, lr_w = params["ffm"]["emb"], params["lr"]["w"]
    temb, tlr = tparams["ffm"]["emb"], tparams["lr"]["w"]
    rng = np.random.default_rng(depth)
    ci = rng.integers(0, CFG.hash_space, FC).astype(np.int32)
    cv = rng.normal(1, 0.25, FC).astype(np.float32)

    jpre = jffm.extend_context_prefix_np(
        JCFG, emb, lr_w, jffm.empty_context_prefix_np(JCFG), ci[:depth],
        cv[:depth])
    tpre = ffm.extend_context_prefix(
        CFG, temb, tlr, ffm.empty_context_prefix(CFG), _t(ci[:depth]),
        _t(cv[:depth]))
    want = jffm.fused_context_state_np(JCFG, emb, lr_w, jpre, ci[depth:],
                                       cv[depth:])
    got = ffm.fused_context_state(CFG, temb, tlr, tpre, _t(ci[depth:]),
                                  _t(cv[depth:]))
    assert got["depth"] == int(want["depth"]) == depth
    for key in ("emb", "val", "pair_sum", "lr_terms"):
        np.testing.assert_allclose(np.asarray(got[key]), want[key],
                                   rtol=1e-5, atol=1e-6, err_msg=key)

    e, v = want["emb"], want["val"]
    dots = (np.einsum("ijk,jik->ij", e[:, :FC], e[:, :FC])
            * v[:, None] * v[None, :]).astype(np.float32)
    want_full = jffm.prefix_state_from_dots_np(JCFG, want, jpre["pairs"], dots)
    got_full = ffm.prefix_state_from_dots(CFG, got, tpre["pairs"], _t(dots))
    staged = ffm.extend_context_prefix(CFG, temb, tlr, tpre, _t(ci[depth:]),
                                       _t(cv[depth:]))
    for key in ("emb", "val", "pairs", "lr_terms"):
        np.testing.assert_allclose(got_full[key].numpy(), want_full[key],
                                   rtol=1e-5, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(got_full[key].numpy(),
                                   staged[key].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("args", [
    dict(emb_absmax=0.3, eps=0.0),
    dict(emb_absmax=1.2, eps=0.01, vmax=2.5),
    dict(emb_absmax=0.05, eps=1e-3, vmax=1.7, lr_max=0.4),
])
def test_fused_logit_tolerance_matches_jax(args):
    assert Q.fused_logit_tolerance(CFG, **args) == \
        JQ.fused_logit_tolerance(JCFG, **args)


def _req(rng, n, ctx=None, cfg=CFG):
    fc, fcand = cfg.context_fields, cfg.n_fields - cfg.context_fields
    ci, cv = ctx if ctx is not None else (
        rng.integers(0, cfg.hash_space, fc).astype(np.int32),
        rng.normal(1, 0.25, fc).astype(np.float32))
    return (ci, cv,
            rng.integers(0, cfg.hash_space, (n, fcand)).astype(np.int32),
            rng.normal(1, 0.25, (n, fcand)).astype(np.float32))


def _empty(ctx, cfg=CFG):
    fcand = cfg.n_fields - cfg.context_fields
    return (ctx[0], ctx[1], np.zeros((0, fcand), np.int32),
            np.zeros((0, fcand), np.float32))


def _tolerance(np_params, engine, reqs, cfg=CFG):
    """test_fused_scoring.py's envelope: f32 rows leave reassociation only."""
    reqs = [r for r in reqs if r[2].size]
    vmax = float(max(max(np.abs(r[1]).max(), np.abs(r[3]).max())
                     for r in reqs))
    absmax = float(np.abs(np_params["ffm"]["emb"]).max())
    eps = Q.row_max_error(engine.params["ffm"]["emb"]) if engine.quantized \
        else 0.0
    return Q.fused_logit_tolerance(cfg, absmax, eps, vmax=vmax)


@pytest.mark.parametrize("quantized,dedup", [(True, True), (False, True),
                                             (True, False)])
def test_fused_engine_matches_jax_fused_engine(quantized, dedup):
    params = _np_params()
    port = InferenceEngine(CFG, "ffm", device="cpu", fused=True,
                           params=params_from_numpy(params, "cpu"),
                           quantized=quantized, dedup=dedup)
    ref = JEngine(JCFG, "ffm", backend="pallas", params=params,
                  quantized=quantized, host_gather=True, fused=True,
                  parallel=1, dedup=dedup)
    assert port.fused and ref.fused
    rng = np.random.default_rng(5)
    hot = (rng.integers(0, CFG.hash_space, FC).astype(np.int32),
           np.ones(FC, np.float32))
    mate = (hot[0].copy(), hot[1])
    mate[0][4:] = rng.integers(0, CFG.hash_space, FC - 4)  # depth-4 prefix
    base = _req(rng, 12)
    batches = [
        [base, (base[0], base[1], base[2][:5], base[3][:5]),   # dedup
         _req(rng, 9, hot), _empty(hot), _req(rng, 3)],
        [_req(rng, 7, mate), _req(rng, 16, hot),               # full hit
         _req(rng, 4, (base[0], base[1])), _empty(_req(rng, 1)[:2])],
    ]
    for batch in batches:
        got, want = port.score_batch(batch), ref.score_batch(batch)
        tol = _tolerance(params, port, batch)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == np.float32
            if w.size:
                assert float(np.abs(g - w).max()) <= tol
    assert (port.hits, port.misses) == (ref.hits, ref.misses)
    for key in ("requests", "candidates", "rows_scored", "ctx_partials_full",
                "ctx_tail_fields"):
        assert getattr(port.stats, key) == getattr(ref.stats, key), key
    assert port.prefix_hit_depths == ref.prefix_hit_depths
    assert port.prefix_hit_depths[FC] > 0 and port.prefix_hit_depths[4] > 0


def _engines12(quantized, **kw):
    params = _np_params(seed=2, cfg=CFG12)
    tparams = params_from_numpy(params, "cpu")
    common = dict(device="cpu", prefix_stride=4, quantized=quantized,
                  warmup_buckets=(8, 32), **kw)
    return (params, InferenceEngine(CFG12, "ffm", params=tparams, **common),
            InferenceEngine(CFG12, "ffm", params=tparams, fused=True, **common))


@pytest.mark.parametrize("quantized", [True, False])
def test_fused_matches_staged_across_warmup_buckets(quantized):
    """Every (request, candidate) bucket the warmed engine can emit — ragged
    sizes, shared contexts (prefix hits at partial depth) and an empty slate
    mixed in — scores within the tolerance of the staged path."""
    params, staged, fused = _engines12(quantized)
    assert fused.fused and not staged.fused
    fc = CFG12.context_fields
    rng = np.random.default_rng(7)
    hot = (rng.integers(0, CFG12.hash_space, fc).astype(np.int32),
           rng.normal(1, 0.25, fc).astype(np.float32))
    batches = [[_req(rng, n_cand, hot if s % 2 else None, CFG12)
                for s in range(n_req)]
               for n_req, n_cand in [(1, 1), (1, 5), (2, 8), (3, 17), (8, 32),
                                     (5, 9)]]
    batches.append([_req(rng, 4, cfg=CFG12), _empty(hot, CFG12)])
    for reqs in batches:
        tol = _tolerance(params, fused, reqs, CFG12)
        for w, g in zip(staged.score_batch(reqs), fused.score_batch(reqs)):
            assert g.shape == w.shape
            if w.size:
                assert float(np.abs(g - w).max()) <= tol, len(reqs)


def test_fused_prefix_cache_learns_and_full_hits():
    """The ctx-dots readback inserts full-depth states: a second pass over
    the same contexts full-hits and still matches the staged path."""
    params, staged, fused = _engines12(True)
    fc = CFG12.context_fields
    rng = np.random.default_rng(11)
    ctxs = [(rng.integers(0, CFG12.hash_space, fc).astype(np.int32),
             rng.normal(1, 0.25, fc).astype(np.float32)) for _ in range(4)]
    first = [_req(rng, 16, c, CFG12) for c in ctxs]
    second = [_req(rng, 16, c, CFG12) for c in ctxs]  # same ctx, new slates
    fused.score_batch(first)
    fused.prefix_hit_depths.clear()
    got = fused.score_batch(second)
    assert fused.prefix_hit_depths == {fc: len(ctxs)}
    staged.score_batch(first)
    want = staged.score_batch(second)
    tol = _tolerance(params, fused, second, CFG12)
    for w, g in zip(want, got):
        assert float(np.abs(g - w).max()) <= tol


def test_fused_selection():
    """``fused=None`` stays staged (the port always gathers on the device,
    where the JAX engine stays staged too); ``fused=True`` needs ``"ffm"``."""
    params = params_from_numpy(_np_params("deepffm"), "cpu")
    for model in ("ffm", "deepffm"):
        assert not InferenceEngine(CFG, model, device="cpu").fused
        assert not InferenceEngine(CFG, model, device="cpu",
                                   quantized=True, params=params).fused
    assert InferenceEngine(CFG, "ffm", device="cpu", fused=True).fused
    with pytest.raises(ValueError, match="ffm"):
        InferenceEngine(CFG, "deepffm", device="cpu", fused=True)
    with pytest.raises(ValueError, match="ffm"):
        ScoringPlan(CFG, "deepffm", fused=True)
