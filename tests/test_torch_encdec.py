"""The port's encoder-decoder family (seamless-m4t-large-v2) against the JAX
package on the CPU.

At ``smoke()`` size in f32 with the JAX package's ``init_params(PRNGKey(0))``
weights carried into the port by ``convert.params_from_numpy``; the norms'
scales and biases initialize to ones and zeros, which would test nothing,
so both sides get the same seeded values for them. Tolerance: rtol 1e-5 and
atol 1e-5 of the largest |value| (``tests/test_torch_llm_families.py``'s
``TOL``):

* the configs equal JAX's field for field;
* ``encode`` and ``forward`` (``test_archs.py::test_smoke_forward_shapes_
  no_nan``'s twin: shapes, no NaN, and JAX's logits), with S_src = S_tgt
  and with S_src != S_tgt either way, so the cross-attention runs Sq != Sk;
* ``prefill_cross``' cross caches and the decode steps after it, step by
  step against JAX's, and the port's decode against its own forward within
  ``test_archs.py::test_decode_matches_forward``'s rel < 5e-3;
* ``LLMServer.generate`` returns JAX's tokens (the stepwise warm-up, cross
  caches zero, as JAX's server), with every step's top-2 logit margin in
  JAX above the logit tolerance;
* LayerNorm and the ReLU FFN against ``repro.models.layers`` on seeded
  inputs in f32 (``TOL``) and bf16 (one bf16 ulp, 2^-7 of the largest
  |value|: both compute in f32 and round once, so a last-bit difference
  before the rounding can move a value by one ulp);
* ``python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --smoke
  --device cpu`` runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import seamless_m4t_large_v2 as j_seamless
from repro.models import encdec as j_encdec
from repro.models import layers as j_layers
from repro.models import registry as j_registry
from repro.serving.server import LLMServer as JLLMServer
from repro_torch import convert
from repro_torch.common.config import ModelConfig
from repro_torch.configs import seamless_m4t_large_v2 as seamless
from repro_torch.kernels import _build
from repro_torch.launch import serve as serve_cli
from repro_torch.models import encdec, layers, registry
from repro_torch.serving.server import LLMServer

ARCH = "seamless-m4t-large-v2"
SEED = 0
TOL = 1e-5  # rtol, and atol as a share of the largest |value|
BF16_TOL = 2.0 ** -7  # one bf16 ulp of the largest |value|
B = 2


def _close(got, want, tol=TOL, what=""):
    got = (got.float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _seed_norms(node, rng):
    """Every norm's scale and bias, in place: scale 1 + N(0, 0.2), bias
    N(0, 0.2)."""
    for name, leaf in node.items():
        if isinstance(leaf, dict):
            _seed_norms(leaf, rng)
        elif name in ("scale", "bias"):
            base = 1.0 if name == "scale" else 0.0
            node[name] = (base + rng.normal(0, 0.2, leaf.shape)).astype(
                leaf.dtype)


@pytest.fixture(scope="module")
def f32():
    """(JAX config, JAX params, port config, port params on the CPU)."""
    jcfg = j_registry.get_config(ARCH, smoke=True)
    cfg = registry.get_config(ARCH, smoke=True)
    tree = jax.tree_util.tree_map(
        np.asarray, j_registry.init_params(jcfg, jax.random.PRNGKey(SEED)))
    _seed_norms(tree, np.random.default_rng(7))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jp, cfg, convert.params_from_numpy(tree, "cpu")


def _tokens(cfg, shape, seed=SEED):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _frames(cfg, s_src, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, s_src, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("make,make_ref", [
    (seamless.config, j_seamless.config), (seamless.smoke, j_seamless.smoke)],
    ids=["config", "smoke"])
def test_config_matches_reference(make, make_ref):
    cfg, ref = make(), make_ref()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg == ModelConfig(**dataclasses.asdict(ref))
    for prop in ("resolved_head_dim", "q_per_kv", "padded_vocab"):
        assert getattr(cfg, prop) == getattr(ref, prop), prop
    assert ARCH in registry.ARCH_IDS
    assert registry.get_config(ARCH, smoke=make is seamless.smoke) == cfg
    assert cfg.resolved_head_dim in (32, 64)  # K11 instances, both bodies


def test_norm_leaves_are_seeded(f32):
    _, _, cfg, tp = f32
    for tree in (tp["enc_layers"]["ln1"], tp["dec_layers"]["ln_x"],
                 tp["ln_f"]):
        assert set(tree) == {"scale", "bias"}
        assert float(tree["bias"].std()) > 0.1
    assert "wg" not in tp["enc_layers"]["ffn"]  # the ReLU FFN: wi, wo


@pytest.mark.parametrize("s_src,s_tgt", [(16, 16), (12, 16), (20, 6)])
def test_forward_matches(f32, s_src, s_tgt):
    jcfg, jp, cfg, tp = f32
    frames, toks = _frames(cfg, s_src), _tokens(cfg, (B, s_tgt))
    before = dict(_build.launches)
    enc = encdec.encode(cfg, tp, torch.from_numpy(frames))
    _close(enc, j_encdec.encode(jcfg, jp, jnp.asarray(frames)),
           what="encoder states")
    got, aux = registry.forward(cfg, tp, {"frames": torch.from_numpy(frames),
                                          "tokens": torch.from_numpy(toks)})
    want, jaux = j_registry.forward(jcfg, jp, {"frames": jnp.asarray(frames),
                                               "tokens": jnp.asarray(toks)})
    assert got.shape == (B, s_tgt, cfg.padded_vocab)
    assert got.dtype == torch.float32
    assert not bool(torch.isnan(got).any())
    _close(got, want, what="logits")
    assert float(aux) == float(jaux) == 0.0
    assert _build.launches == before  # CPU tensors: no kernel


def test_decode_after_prefill_cross_matches(f32):
    """prefill_cross, then 12 decode steps on fixed tokens, against JAX's
    state and logits step by step."""
    jcfg, jp, cfg, tp = f32
    s_src, steps = 10, 12
    frames, feed = _frames(cfg, s_src), _tokens(cfg, (steps, B), seed=5)
    jstate = j_registry.init_decode_state(jcfg, B, steps, src_len=s_src)
    jstate = j_encdec.prefill_cross(jcfg, jp, jstate, jnp.asarray(frames))
    tstate = registry.init_decode_state(cfg, B, steps, src_len=s_src,
                                        device="cpu")
    tstate = encdec.prefill_cross(cfg, tp, tstate, torch.from_numpy(frames))
    for name in ("cross_k", "cross_v"):
        assert tstate[name].shape == (cfg.n_layers, B, s_src, cfg.n_kv_heads,
                                      cfg.resolved_head_dim)
        _close(tstate[name], jstate[name], what=name)
    for i in range(steps):
        got, tstate = registry.decode_step(cfg, tp, tstate,
                                           torch.from_numpy(feed[i]))
        want, jstate = j_registry.decode_step(jcfg, jp, jstate,
                                              jnp.asarray(feed[i]))
        assert tstate["pos"] == int(jstate["pos"]) == i + 1
        _close(got, want, what=f"decode step {i}")
    for name in ("k", "v"):
        _close(tstate["self"][name], jstate["self"][name],
               what=f"self cache {name}")


def test_port_decode_matches_its_forward(f32):
    """``test_archs.py::test_decode_matches_forward``'s contract (rel <
    5e-3) inside the port, with S_src != S_tgt."""
    _, _, cfg, tp = f32
    s_src, s = 10, 12
    frames = torch.from_numpy(_frames(cfg, s_src, seed=3))
    toks = torch.from_numpy(_tokens(cfg, (B, s), seed=2))
    full, _ = registry.forward(cfg, tp, {"frames": frames, "tokens": toks})
    state = registry.init_decode_state(cfg, B, s, src_len=s_src, device="cpu")
    state = encdec.prefill_cross(cfg, tp, state, frames)
    outs = []
    for i in range(s):
        lg, state = registry.decode_step(cfg, tp, state, toks[:, i])
        outs.append(lg)
    dec = torch.stack(outs, 1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 5e-3, rel


def test_prefill_cross_refuses_other_lengths(f32):
    _, _, cfg, tp = f32
    state = registry.init_decode_state(cfg, B, 8, src_len=10, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        encdec.prefill_cross(cfg, tp, state,
                             torch.from_numpy(_frames(cfg, 12)))
    with pytest.raises(ValueError, match="n_enc_layers"):
        encdec.param_specs(cfg.replace(n_enc_layers=0))


def test_generate_matches(f32):
    jcfg, jp, cfg, tp = f32
    prompts, gen_len = _tokens(cfg, (B, 12)), 8
    want = np.asarray(JLLMServer(jcfg, jp).generate(jnp.asarray(prompts),
                                                    gen_len))
    server = LLMServer(cfg, tp, device="cpu")
    got = server.generate(torch.from_numpy(prompts), gen_len)
    assert got.dtype == torch.int32 and got.shape == (B, gen_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert server.stats.requests == B and server.stats.candidates == B * gen_len
    # JAX's server warms up step by step (no batched prefill for encdec);
    # the top two logits behind every greedy choice must differ by more
    # than the logit tolerance for equal tokens to mean something
    p = prompts.shape[1]
    state = j_registry.init_decode_state(jcfg, B, p + gen_len + 1)
    for i in range(p):
        lg, state = j_registry.decode_step(jcfg, jp, state,
                                           jnp.asarray(prompts[:, i]))
    for i in range(gen_len):
        lg = np.asarray(lg)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        assert margin > TOL * float(np.abs(lg).max()) + TOL * float(
            np.abs(top2).max()), f"step {i}: top-2 margin {margin}"
        np.testing.assert_array_equal(lg.argmax(-1), want[:, i])
        lg, state = j_registry.decode_step(jcfg, jp, state,
                                           jnp.asarray(want[:, i]))


def _as_jax(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(dtype)


def _as_torch(a: np.ndarray, dtype: str):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_relu_ffn_match(dtype):
    cfg = registry.get_config(ARCH, smoke=True).replace(dtype=dtype,
                                                        param_dtype=dtype)
    jcfg = j_registry.get_config(ARCH, smoke=True).replace(dtype=dtype,
                                                           param_dtype=dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(11)
    d, f = cfg.d_model, cfg.d_ff
    x = (rng.normal(size=(3, 5, d)) * 2 + 0.5).astype(np.float32)
    norm = {"scale": (1 + rng.normal(0, 0.2, d)).astype(np.float32),
            "bias": rng.normal(0, 0.2, d).astype(np.float32)}
    ffn = {"wi": (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32),
           "wo": (rng.normal(size=(f, d)) / np.sqrt(f)).astype(np.float32)}
    assert set(layers.norm_specs(cfg)) == set(norm)
    assert set(layers.ffn_specs(cfg)) == set(ffn)

    def run(p, fn, jfn, inp):
        got = fn(cfg, {k: _as_torch(v, dtype) for k, v in p.items()},
                 _as_torch(inp, dtype))
        want = jfn(jcfg, {k: _as_jax(v, dtype) for k, v in p.items()},
                   _as_jax(inp, dtype))
        assert str(got.dtype).removeprefix("torch.") == dtype
        return got, np.asarray(want.astype(jnp.float32))

    got, want = run(norm, layers.apply_norm, j_layers.apply_norm, x)
    _close(got, want, tol, "LayerNorm")
    # a layernorm config without the bias leaf takes RMSNorm, as in JAX
    got, want = run({"scale": norm["scale"]}, layers.apply_norm,
                    j_layers.apply_norm, x)
    _close(got, want, tol, "RMSNorm under norm='layernorm'")
    got, want = run(ffn, layers.apply_ffn, j_layers.apply_ffn, x)
    _close(got, want, tol, "ReLU FFN")
    # the ReLU zeroes the hidden units on both sides: the FFN of -x differs
    got2, _ = run(ffn, layers.apply_ffn, j_layers.apply_ffn, -x)
    assert not torch.allclose(got2.float(), -got.float())


def test_gelu_stays_refused():
    cfg = registry.get_config(ARCH, smoke=True).replace(act="gelu")
    with pytest.raises(NotImplementedError, match="gelu"):
        layers.ffn_specs(cfg)
    with pytest.raises(NotImplementedError, match="gelu"):
        layers.apply_ffn(cfg, {}, torch.zeros(1, cfg.d_model))


def test_bf16_weights_cross_bit_for_bit():
    jcfg = j_registry.get_config(ARCH, smoke=True).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    cfg = registry.get_config(ARCH, smoke=True).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    jp = j_registry.init_params(jcfg, jax.random.PRNGKey(SEED))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            convert.params_to_numpy(node).view(ml_dtypes.bfloat16),
            np.asarray(leaf))
    # and the bf16 decode runs: finite logits after prefill_cross
    frames = torch.from_numpy(_frames(cfg, 6))
    state = registry.init_decode_state(cfg, B, 4, src_len=6, device="cpu")
    state = encdec.prefill_cross(cfg, tp, state, frames)
    assert state["cross_k"].dtype == torch.bfloat16
    lg, state = registry.decode_step(cfg, tp, state,
                                     torch.zeros(B, dtype=torch.int32))
    assert lg.shape == (B, cfg.padded_vocab) and bool(torch.isfinite(lg).all())


def test_serve_launcher_runs_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--batch", "2", "--gen", "4"]) == 0
    assert f"{ARCH} on cpu: 2x4 tokens" in capsys.readouterr().out
