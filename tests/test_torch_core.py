"""Port core modules against the JAX package on the CPU.

``repro_torch.core`` (quantization, FFM primitives, DeepFFM forward) and
``repro_torch.common.pspec`` against ``repro.core`` / ``repro.common`` on
the same seeded numpy inputs. Integer results (int8 codes, index orders) are
held bit for bit, float results to the reference's tolerances.
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
from repro_torch.common import pspec
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import deepffm, ffm
from repro_torch.core import quantization as Q
from repro_torch.kernels.ffm_interaction import ops as t_ops

CFG = FFMConfig(n_fields=8, context_fields=5, hash_space=2**10, k=4,
                mlp_hidden=(16, 8))
JCFG = JFFMConfig(**CFG.__dict__)


@pytest.fixture(autouse=True)
def _pinned_gather_cliff(monkeypatch):
    # the JAX package's int8 gather consults a per-process calibration probe
    # of its host gather; pin its constant so the reference runs no probe
    monkeypatch.setenv("REPRO_CLIFF_CALIBRATE", "0")


def _np_params(model: str, seed: int = 0):
    """JAX-initialized params as a numpy tree, with non-zero LR weights and
    a non-zero final MLP layer so every part of the head contributes."""
    params = jax.tree_util.tree_map(
        np.asarray, jdeepffm.init_params(JCFG, jax.random.PRNGKey(seed), model))
    rng = np.random.default_rng(seed + 1)
    params["lr"]["w"] = rng.normal(0, 0.1, CFG.hash_space).astype(np.float32)
    if "ffm" in params:
        params["ffm"]["emb"] = rng.normal(
            0, 0.3, params["ffm"]["emb"].shape).astype(np.float32)
    if "mlp" in params:
        last = f"w{len(CFG.mlp_hidden)}"
        params["mlp"][last] = rng.normal(
            0, 0.5, params["mlp"][last].shape).astype(np.float32)
    return params


def _at(tree, path):
    for key in path:
        if key not in tree:
            return None
        tree = tree[key]
    return tree


# -- int8 serving format -------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 6, 4), (1, 8), (300, 24, 8), (17, 3)])
def test_quantize_rows_bit_exact(shape):
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(0, 0.1, shape).astype(np.float32)
    w[0] = 0.25                      # constant row: scale 1, codes 0
    if shape[0] > 2:
        w[2] *= 100.0                # a wild row keeps its own grid
    got, want = Q.quantize_rows(w), JQ.quantize_rows(w)
    for key in ("codes", "scale", "zero"):
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype
    np.testing.assert_array_equal(Q.dequantize_rows(got),
                                  JQ.dequantize_rows(want))
    assert Q.row_max_error(got) == JQ.row_max_error(want)
    assert Q.is_row_quantized(got) and not Q.is_block_quantized(got)


@pytest.mark.parametrize("v,block", [(64, 64), (100, 64), (1000, 16), (5, 64)])
def test_quantize_blocks_bit_exact(v, block):
    rng = np.random.default_rng(v + block)
    w = rng.normal(0, 0.1, v).astype(np.float32)
    got, want = Q.quantize_blocks(w, block), JQ.quantize_blocks(w, block)
    assert got["block"] == want["block"]
    for key in ("codes", "scale", "zero"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(Q.dequantize_blocks(got),
                                  JQ.dequantize_blocks(want))
    assert Q.block_max_error(got) == JQ.block_max_error(want)
    assert Q.is_block_quantized(got) and not Q.is_row_quantized(got)


@pytest.mark.parametrize("model", ["ffm", "deepffm", "mlp"])
def test_quantize_params_rows_matches_reference(model):
    """Quantized trees hold the same codes and grids as the JAX package's,
    on the params' device; non-table leaves are shared, not copied."""
    params = _np_params(model)
    want = JQ.quantize_params_rows(params)
    tparams = params_from_numpy(params, "cpu")
    got = Q.quantize_params_rows(tparams)
    assert got.keys() == want.keys()
    for path in (("ffm", "emb"), ("emb",), ("lr", "w")):
        g, w = _at(got, path), _at(want, path)
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert g.keys() == w.keys()
        for key in ("codes", "scale", "zero"):
            assert isinstance(g[key], torch.Tensor)
            np.testing.assert_array_equal(g[key].numpy(), w[key])
    assert got["lr"]["b"] is tparams["lr"]["b"]
    # quantizing a quantized tree changes nothing
    again = Q.quantize_params_rows(got)
    assert _at(again, ("lr", "w")) is _at(got, ("lr", "w"))
    eps = Q.row_max_error(_at(got, ("emb",) if model == "mlp" else ("ffm", "emb")))
    assert Q.pair_logit_tolerance(CFG, 0.5, eps, 2.0, 1e-3) == \
        JQ.pair_logit_tolerance(JCFG, 0.5, eps, 2.0, 1e-3)


# -- FFM primitives ------------------------------------------------------------

@pytest.mark.parametrize("n_fields,fc", [(8, 5), (24, 16), (3, 1), (12, 8)])
def test_index_orders_equal(n_fields, fc):
    cfg = CFG.replace(n_fields=n_fields, context_fields=fc)
    jcfg = JCFG.replace(n_fields=n_fields, context_fields=fc)
    for a, b in zip(ffm.pair_indices(n_fields), jffm.pair_indices(n_fields)):
        np.testing.assert_array_equal(a, b)
    (pi, pj), cc, xc, aa = ffm.pair_split(cfg)
    (jpi, jpj), jcc, jxc, jaa = jffm.pair_split(jcfg)
    for a, b in ((pi, jpi), (pj, jpj), (cc, jcc), (xc, jxc), (aa, jaa)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ffm.prefix_pair_order(fc), jffm.prefix_pair_order(fc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ffm.prefix_to_cc_perm(cfg),
                                  jffm.prefix_to_cc_perm(jcfg))
    for p in range(fc + 1):
        assert ffm.prefix_pair_count(p) == jffm.prefix_pair_count(p)
        for a, b in zip(ffm.tail_pair_gather(fc, p), jffm.tail_pair_gather(fc, p)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("depth", [0, 2, 4])
def test_extend_context_prefix_matches_np(quantized, depth):
    """Extending a depth-p prefix to full depth on the port equals the JAX
    host twin ``extend_context_prefix_np``; the state slices back to p."""
    params = _np_params("ffm")
    if quantized:
        params = JQ.quantize_params_rows(params)
    emb, lr_w = params["ffm"]["emb"], params["lr"]["w"]
    temb = params_from_numpy({"t": emb}, "cpu")["t"]
    tlr = params_from_numpy({"t": lr_w}, "cpu")["t"]
    rng = np.random.default_rng(depth)
    fc = CFG.context_fields
    ci = rng.integers(0, CFG.hash_space, fc).astype(np.int32)
    cv = rng.uniform(0.5, 2.0, fc).astype(np.float32)

    jbase = jffm.extend_context_prefix_np(
        JCFG, emb, lr_w, jffm.empty_context_prefix_np(JCFG), ci[:depth],
        cv[:depth])
    want = jffm.extend_context_prefix_np(JCFG, emb, lr_w, jbase, ci[depth:],
                                         cv[depth:])
    full = ffm.extend_context_prefix(
        CFG, temb, tlr, ffm.empty_context_prefix(CFG, device="cpu"),
        torch.from_numpy(ci), torch.from_numpy(cv))
    base = ffm.slice_context_prefix(full, depth)
    got = ffm.extend_context_prefix(CFG, temb, tlr, base,
                                    torch.from_numpy(ci[depth:]),
                                    torch.from_numpy(cv[depth:]))
    for key in ("emb", "val", "pairs", "lr_terms"):
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), want[key],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(base[key].numpy(), jbase[key],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["linear", "mlp", "ffm", "deepffm"])
@pytest.mark.parametrize("quantized", [False, True])
def test_forward_matches_jax(model, quantized):
    """``deepffm.forward`` and ``predict_proba`` against the JAX forward on
    the same weights; ffm/deepffm also through the kernel ops'
    ``interactions`` (its plain version here)."""
    params = _np_params(model)
    if quantized:
        params = JQ.quantize_params_rows(params)
    tparams = params_from_numpy(params, "cpu")
    rng = np.random.default_rng(11)
    idx = rng.integers(0, CFG.hash_space, (13, CFG.n_fields)).astype(np.int32)
    val = rng.uniform(0.5, 2.0, (13, CFG.n_fields)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(jdeepffm.forward(JCFG, jparams, jnp.asarray(idx),
                                       jnp.asarray(val), model))
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    got = deepffm.forward(CFG, tparams, ti, tv, model).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    if model in ("ffm", "deepffm"):
        kern = deepffm.forward(CFG, tparams, ti, tv, model,
                               interactions_fn=t_ops.interactions).numpy()
        np.testing.assert_allclose(kern, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        deepffm.predict_proba(CFG, tparams, ti, tv, model).numpy(),
        np.asarray(jax.nn.sigmoid(want)), rtol=2e-4, atol=2e-5)
    ci, cv, ki, kv = deepffm.split_request(CFG, ti, tv)
    assert tuple(ki.shape) == (13, CFG.n_fields - CFG.context_fields)
    np.testing.assert_array_equal(ci.numpy(), idx[0, :CFG.context_fields])


@pytest.mark.parametrize("model", ["linear", "mlp", "ffm", "deepffm"])
def test_param_specs_and_materialize(model):
    """Spec trees match the JAX package's in structure, shapes and init
    kinds; ``materialize`` is reproducible per seed and honours the kinds."""
    want = jdeepffm.param_specs(JCFG, model)
    got = deepffm.param_specs(CFG, model)
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: hasattr(x, "init"))[0]
    for path, spec in flat_w:
        node = got
        for key in path:
            node = node[key.key]
        assert node.shape == spec.shape and node.axes == spec.axes
        assert node.init == spec.init
        assert node.dtype == torch.float32
    a = deepffm.init_params(CFG, 3, model, "cpu")
    b = deepffm.init_params(CFG, 3, model, "cpu")
    c = deepffm.init_params(CFG, 4, model, "cpu")
    np.testing.assert_array_equal(a["lr"]["w"].numpy(), 0.0)
    if model != "linear":
        key = ("ffm", "emb") if "ffm" in a else ("emb",)
        ta, tb, tc = (_at(t, key) for t in (a, b, c))
        assert torch.equal(ta, tb) and not torch.equal(ta, tc)
        assert tuple(ta.shape) == (CFG.hash_space, CFG.n_fields, CFG.k)
        assert 0.015 < float(ta.std()) < 0.025   # "embed": normal(0, 0.02)
    with pytest.raises(ValueError):
        pspec.ParamSpec((2, 3), ("null",))
