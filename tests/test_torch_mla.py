"""The port's deepseek-v2-236b (multi-head latent attention and the shared
experts, ``models/attention.py`` and ``models/moe.py``) against the JAX
package on the CPU.

At ``smoke()`` size in f32 (qk / v head dims 48 / 32, latent rank 32, four
experts top-2 beside one shared expert) with the JAX package's
``init_params(PRNGKey(0))`` weights carried into the port by
``convert.params_from_numpy``; ``q_norm``, ``kv_norm`` and the RMSNorm
scales initialize to ones, which would test nothing, so both sides get the
same seeded values for them. Tolerance: rtol 1e-5 and atol 1e-5 of the
largest |value| (``tests/test_torch_llm_families.py``'s ``TOL``):

* the configs equal JAX's field for field, and ``mla_specs`` (with the
  ``moe`` leaf's ``shared`` FFN) equals JAX's leaf for leaf;
* ``_mla_q`` and ``_mla_latent``; ``mla_forward`` through the port's
  flash wrapper at (48, 32), v unpadded, against JAX's (which pads v to 48
  and slices the result back), on CPU tensors (the plain version, no
  launch);
* ``mla_decode`` step by step against JAX's, the latent cache included and
  written in place;
* ``moe_forward`` with the shared expert, ``aux`` on and off, and the
  router's top-k gap above the tolerance;
* ``forward`` (``test_archs.py::test_smoke_forward_shapes_no_nan``'s twin:
  shapes, no NaN, JAX's logits and aux); decode step by step against JAX's,
  and the port's absorbed decode against its own expanded forward within
  ``test_archs.py::test_decode_matches_forward``'s rel < 5e-3;
* ``transformer.prefill`` raises for MLA, as JAX's does;
* ``LLMServer.generate`` returns JAX's tokens (the stepwise warm-up, as
  JAX's server), every step's top-2 logit margin in JAX above the logit
  tolerance and every routed token's top-k gap above the tolerance;
* bf16 weights cross bit for bit, and the bf16 decode runs;
* ``python -m repro_torch.launch.serve --arch deepseek-v2-236b --smoke
  --device cpu`` runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.common import pspec as j_pspec
from repro.configs import deepseek_v2_236b as j_deepseek
from repro.models import attention as j_attention
from repro.models import moe as j_moe
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro.serving.server import LLMServer as JLLMServer
from repro_torch import convert
from repro_torch.common import pspec
from repro_torch.common.config import ModelConfig
from repro_torch.configs import deepseek_v2_236b as deepseek
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, moe, registry, transformer
from repro_torch.serving.server import LLMServer

ARCH = "deepseek-v2-236b"
SEED = 0
TOL = 1e-5  # rtol, and atol as a share of the largest |value|
B = 2


def _close(got, want, tol=TOL, what=""):
    got = (got.float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def seed_constant_leaves(node, rng):
    """In place, every leaf that initializes to ones: the RMSNorm scales and
    MLA's ``q_norm`` / ``kv_norm``, 1 + N(0, 0.2)."""
    for name, leaf in node.items():
        if isinstance(leaf, dict):
            seed_constant_leaves(leaf, rng)
        elif name in ("scale", "q_norm", "kv_norm"):
            node[name] = (1.0 + rng.normal(0, 0.2, leaf.shape)).astype(
                leaf.dtype)


@pytest.fixture(scope="module")
def f32():
    """(JAX config, JAX params, port config, port params on the CPU)."""
    jcfg = j_registry.get_config(ARCH, smoke=True)
    cfg = registry.get_config(ARCH, smoke=True)
    tree = jax.tree_util.tree_map(
        np.asarray, j_registry.init_params(jcfg, jax.random.PRNGKey(SEED)))
    seed_constant_leaves(tree, np.random.default_rng(7))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jp, cfg, convert.params_from_numpy(tree, "cpu")


def _jax_decode(jcfg):
    """JAX's ``decode_step`` under ``jit`` (one compile; op by op it takes
    seconds a step)."""
    return jax.jit(lambda p, st, t: j_registry.decode_step(jcfg, p, st, t))


def _tokens(cfg, shape, seed=SEED):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _layer(tree, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _x(cfg, s, seed):
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


def _router_gaps(cfg, probs):
    """The gap between each token's k-th and (k+1)-th router probability."""
    top = np.sort(np.asarray(probs, np.float32), axis=-1)[:, ::-1]
    return top[:, cfg.top_k - 1] - top[:, cfg.top_k], float(top.max())


@pytest.mark.parametrize("make,make_ref", [
    (deepseek.config, j_deepseek.config), (deepseek.smoke, j_deepseek.smoke)],
    ids=["config", "smoke"])
def test_config_matches_reference(make, make_ref):
    cfg, ref = make(), make_ref()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg == ModelConfig(**dataclasses.asdict(ref))
    assert ARCH in registry.ARCH_IDS
    assert set(registry.ARCH_IDS) == set(j_registry.ARCH_IDS)
    assert registry.get_config(ARCH, smoke=make is deepseek.smoke) == cfg
    # the kernel's (qk, v) head dims of this config
    pair = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
    assert pair == ((48, 32) if make is deepseek.smoke else (192, 128))
    for dtype in (torch.float32, torch.bfloat16):
        assert pair in flash_ops.BODIES[dtype][1]


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
def test_mla_and_shared_expert_specs_match(smoke):
    jcfg = j_registry.get_config(ARCH, smoke=smoke)
    cfg = registry.get_config(ARCH, smoke=smoke)
    for ours, theirs in ((attention.mla_specs(cfg),
                          j_attention.mla_specs(jcfg)),
                         (moe.moe_specs(cfg), j_moe.moe_specs(jcfg))):
        flat = jax.tree_util.tree_flatten_with_path(
            theirs, is_leaf=j_pspec.is_spec)[0]
        want = {tuple(p.key for p in path): s for path, s in flat}
        got = {}

        def walk(node, prefix=()):
            for k, v in node.items():
                if pspec.is_spec(v):
                    got[prefix + (k,)] = v
                else:
                    walk(v, prefix + (k,))

        walk(ours)
        assert sorted(got) == sorted(want)
        for path, s in got.items():
            t = want[path]
            assert (s.shape, s.axes, s.init, s.fan_in) == \
                (t.shape, t.axes, t.init, t.fan_in), path
            assert (str(s.dtype).removeprefix("torch.")
                    == jnp.dtype(t.dtype).name), path
    # the shared experts: one SwiGLU FFN of n_shared_experts * d_ff_expert
    shared = moe.moe_specs(cfg)["shared"]
    assert shared["wi"].shape == (cfg.d_model,
                                  cfg.n_shared_experts * cfg.d_ff_expert)


def test_constant_leaves_are_seeded(f32):
    _, _, _, tp = f32
    attn = tp["layers"]["attn"]
    for name in ("q_norm", "kv_norm"):
        assert float(attn[name].std()) > 0.1, name
    assert float(tp["ln_f"]["scale"].std()) > 0.1


def test_mla_q_and_latent_match(f32):
    jcfg, jp, cfg, tp = f32
    ta, ja = transformer.unstack(tp["layers"])[0]["attn"], \
        _layer(jp["layers"])["attn"]
    x = _x(cfg, 13, 3)
    pos = np.arange(13)[None, :]
    tpos = torch.from_numpy(pos)
    q_nope, q_rope = attention._mla_q(cfg, ta, torch.from_numpy(x), tpos)
    jq_nope, jq_rope = j_attention._mla_q(jcfg, ja, jnp.asarray(x),
                                          jnp.asarray(pos))
    _close(q_nope, jq_nope, what="q_nope")
    _close(q_rope, jq_rope, what="q_rope")
    assert q_nope.shape == (B, 13, cfg.n_heads, cfg.qk_nope_dim)
    ckv, k_rope = attention._mla_latent(cfg, ta, torch.from_numpy(x), tpos)
    jckv, jk_rope = j_attention._mla_latent(jcfg, ja, jnp.asarray(x),
                                            jnp.asarray(pos))
    _close(ckv, jckv, what="ckv")
    _close(k_rope, jk_rope, what="k_rope")
    assert ckv.shape == (B, 13, cfg.kv_lora_rank)
    assert k_rope.shape == (B, 13, cfg.qk_rope_dim)


def test_mla_forward_matches(f32, monkeypatch):
    """Through the port's flash wrapper at qk / v dims (48, 32), v
    unpadded, the plain version on CPU tensors (no launch)."""
    jcfg, jp, cfg, tp = f32
    ta, ja = transformer.unstack(tp["layers"])[0]["attn"], \
        _layer(jp["layers"])["attn"]
    x = _x(cfg, 20, 4)
    seen = []
    call = flash_ops.flash_attention

    def recording(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     kw.get("causal")))
        return call(q, k, v, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention", recording)
    before = dict(_build.launches)
    got = attention.mla_forward(cfg, ta, torch.from_numpy(x))
    want = j_attention.mla_forward(jcfg, ja, jnp.asarray(x))
    _close(got, want, what="mla_forward")
    assert _build.launches == before
    h = cfg.n_heads
    assert seen == [((B, 20, h, 48), (B, 20, h, 48), (B, 20, h, 32), True)]


def test_mla_decode_matches_step_by_step(f32):
    """Each step's output and the latent cache against JAX's; the port's
    cache tensors are the ones it was given, written in place."""
    jcfg, jp, cfg, tp = f32
    ta, ja = transformer.unstack(tp["layers"])[0]["attn"], \
        _layer(jp["layers"])["attn"]
    steps = 9
    xs = np.random.default_rng(5).normal(
        size=(steps, B, 1, cfg.d_model)).astype(np.float32)
    cache = attention.init_mla_cache(cfg, B, steps, device="cpu")
    jcache = j_attention.init_mla_cache(jcfg, B, steps)
    ckv, kr = cache["ckv"], cache["kr"]
    assert ckv.shape == (B, steps, cfg.kv_lora_rank)
    assert kr.shape == (B, steps, cfg.qk_rope_dim)
    for i, x in enumerate(xs):
        got, cache = attention.mla_decode(cfg, ta, torch.from_numpy(x), cache,
                                          i)
        want, jcache = j_attention.mla_decode(jcfg, ja, jnp.asarray(x),
                                              jcache, i)
        _close(got, want, what=f"step {i}")
        for name in ("ckv", "kr"):
            _close(cache[name], jcache[name], what=f"{name} after step {i}")
        assert cache["ckv"] is ckv and cache["kr"] is kr


def test_shared_expert_moe_matches(f32):
    jcfg, jp, cfg, tp = f32
    x = _x(cfg, 16, 6)
    for layer in range(cfg.n_layers):
        tm = transformer.unstack(tp["layers"])[layer]["moe"]
        jm = _layer(jp["layers"], layer)["moe"]
        assert set(tm["shared"]) == {"wi", "wg", "wo"}
        y, aux = moe.moe_forward(cfg, tm, torch.from_numpy(x))
        jy, jaux = j_moe.moe_forward(jcfg, jm, jnp.asarray(x))
        _close(y, jy, what=f"layer {layer} y")
        _close(aux, jaux, what=f"layer {layer} aux")
        # equal routing means something only away from a near tie
        _, _, jprobs = j_moe._router(jcfg, jm["router"],
                                     jnp.asarray(x.reshape(-1, cfg.d_model)))
        gaps, top = _router_gaps(cfg, jprobs)
        assert float(gaps.min()) > 2 * TOL * top, gaps.min()
        # the shared expert is added after the routed combine
        dense, _ = moe.moe_dense(cfg, tm, torch.from_numpy(x))
        shared = y - dense
        assert float(shared.abs().max()) > 0.1
        # decode asks for no aux: the same y, and none computed
        y2, aux2 = moe.moe_forward(cfg, tm, torch.from_numpy(x), aux=False)
        assert aux2 is None and torch.equal(y2, y)


def test_forward_matches(f32):
    jcfg, jp, cfg, tp = f32
    s = 20
    toks = _tokens(cfg, (B, s))
    before = dict(_build.launches)
    got, aux = registry.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    want, jaux = j_registry.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    assert got.shape == (B, s, cfg.padded_vocab) and got.dtype == torch.float32
    assert not bool(torch.isnan(got).any())
    _close(got, want, what="logits")
    _close(aux, jaux, what="aux")
    assert float(aux) > 0
    assert _build.launches == before  # CPU tensors: the plain version


def test_decode_matches_step_by_step(f32):
    jcfg, jp, cfg, tp = f32
    steps = 12
    feed = _tokens(cfg, (steps, B), seed=5)
    state = registry.init_decode_state(cfg, B, steps, device="cpu")
    jstate = j_registry.init_decode_state(jcfg, B, steps)
    assert set(state["cache"]) == {"ckv", "kr"}
    jdecode = _jax_decode(jcfg)
    for i in range(steps):
        got, state = registry.decode_step(cfg, tp, state,
                                          torch.from_numpy(feed[i]))
        want, jstate = jdecode(jp, jstate, jnp.asarray(feed[i]))
        assert state["pos"] == int(jstate["pos"]) == i + 1
        _close(got, want, what=f"decode step {i}")
    for name in ("ckv", "kr"):
        assert state["cache"][name].shape[0] == cfg.n_layers
        _close(state["cache"][name], jstate["cache"][name], what=name)


def test_port_decode_matches_its_forward(f32):
    """``test_archs.py::test_decode_matches_forward``'s contract (rel <
    5e-3) inside the port: the absorbed decode against the expanded
    forward."""
    _, _, cfg, tp = f32
    s = 16
    toks = torch.from_numpy(_tokens(cfg, (B, s), seed=2))
    full, _ = registry.forward(cfg, tp, {"tokens": toks})
    state = registry.init_decode_state(cfg, B, s, device="cpu")
    outs = []
    for i in range(s):
        lg, state = registry.decode_step(cfg, tp, state, toks[:, i])
        outs.append(lg)
    dec = torch.stack(outs, 1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 5e-3, rel


def test_prefill_raises_for_mla(f32):
    jcfg, jp, cfg, tp = f32
    toks = _tokens(cfg, (B, 4))
    state = registry.init_decode_state(cfg, B, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="GQA"):
        transformer.prefill(cfg, tp, torch.from_numpy(toks), state)
    with pytest.raises(NotImplementedError):
        j_transformer.prefill(jcfg, jp, jnp.asarray(toks),
                              j_registry.init_decode_state(jcfg, B, 8))


def test_generate_matches(f32, monkeypatch):
    jcfg, jp, cfg, tp = f32
    prompts, gen_len = _tokens(cfg, (B, 10)), 8
    want = np.asarray(JLLMServer(jcfg, jp).generate(jnp.asarray(prompts),
                                                    gen_len))
    routed = []
    router = moe._router

    def recording(*a):
        routed.append(router(*a))
        return routed[-1]

    monkeypatch.setattr(moe, "_router", recording)
    server = LLMServer(cfg, tp, device="cpu")
    got = server.generate(torch.from_numpy(prompts), gen_len)
    assert got.dtype == torch.int32 and got.shape == (B, gen_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert server.stats.requests == B and server.stats.candidates == B * gen_len
    # every routed token stands away from a tie between its k-th and
    # (k+1)-th expert (the port's probabilities are JAX's within TOL)
    assert len(routed) == cfg.n_layers * (prompts.shape[1] + gen_len)
    for _, _, probs in routed:
        gaps, top = _router_gaps(cfg, probs.numpy())
        assert float(gaps.min()) > 2 * TOL * top, gaps.min()
    # JAX's server warms up step by step (no batched prefill for moe); the
    # top two logits behind every greedy choice must differ by more than
    # the logit tolerance for equal tokens to mean something
    p = prompts.shape[1]
    state = j_registry.init_decode_state(jcfg, B, p + gen_len + 1)
    jdecode = _jax_decode(jcfg)
    for i in range(p):
        lg, state = jdecode(jp, state, jnp.asarray(prompts[:, i]))
    for i in range(gen_len):
        lg = np.asarray(lg)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        assert margin > TOL * float(np.abs(lg).max()) + TOL * float(
            np.abs(top2).max()), f"step {i}: top-2 margin {margin}"
        np.testing.assert_array_equal(lg.argmax(-1), want[:, i])
        lg, state = jdecode(jp, state, jnp.asarray(want[:, i]))


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
        want_dt = (torch.float32 if path[-1].key == "router"
                   else torch.bfloat16)
        assert node.dtype == want_dt, path
        got = convert.params_to_numpy(node)
        if want_dt == torch.bfloat16:
            got = got.view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(got, np.asarray(leaf))
    # the bf16 decode runs on a bf16 latent cache
    state = registry.init_decode_state(cfg, B, 4, device="cpu")
    assert {a.dtype for a in state["cache"].values()} == {torch.bfloat16}
    lg, state = registry.decode_step(cfg, tp, state,
                                     torch.zeros(B, dtype=torch.int32))
    assert lg.shape == (B, cfg.padded_vocab) and bool(torch.isfinite(lg).all())


def test_serve_launcher_runs_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--batch", "2", "--gen", "4"]) == 0
    assert f"{ARCH} on cpu: 2x4 tokens" in capsys.readouterr().out
