"""The port's LLM serving path against the JAX package on the CPU.

``llama32_1b.smoke()`` (f32), with the JAX package's random weights from
``registry.init_params(cfg, PRNGKey(seed))`` carried into the port by
``convert.params_from_numpy``:

* ``layers.apply_norm`` / ``apply_rope`` / ``apply_ffn``,
  ``attention.gqa_forward``, ``transformer.forward`` logits, ``prefill``
  (last logits and the cache's first S slots) and 8 ``decode_step``s after
  it agree within rtol 1e-5 and atol 1e-5 of the largest |value|; so does a
  windowed prefill + decode whose ring buffer wraps;
* ``LLMServer.generate`` returns JAX's tokens, and every step's top-2 logit
  margin in JAX exceeds the logit tolerance, so equal tokens mean something;
* bf16 weights cross bit for bit, and the bf16 prefill's logits agree within
  3e-2 of the largest |logit| (the reference's bf16 flash tolerance);
* the port's stepwise decode matches its own forward within the
  reference's ``rel < 5e-3`` (``test_archs.py``);
* the full-width ``param_specs(config())`` of every ported arch id equals
  JAX's leaf for leaf; what is not ported raises, naming ROADMAP.md.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.common import pspec as j_pspec
from repro.configs import llama32_1b as j_llama
from repro.models import attention as j_attention
from repro.models import layers as j_layers
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro.serving.server import LLMServer as JLLMServer
from repro_torch import convert
from repro_torch.common import pspec
from repro_torch.configs import llama32_1b
from repro_torch.kernels import _build
from repro_torch.models import attention, layers, registry, transformer
from repro_torch.serving.server import LLMServer

SEED = 0
TOL = 1e-5  # rtol, and atol as a share of the largest |value|


def _close(got, want, tol=TOL, what=""):
    got = (got.float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _params(dtype="float32"):
    """(JAX config, JAX params, port config, port params on the CPU)."""
    jcfg = j_llama.smoke().replace(dtype=dtype, param_dtype=dtype)
    cfg = llama32_1b.smoke().replace(dtype=dtype, param_dtype=dtype)
    jp = j_registry.init_params(jcfg, jax.random.PRNGKey(SEED))
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, cfg, convert.params_from_numpy(np_tree, "cpu")


@pytest.fixture(scope="module")
def f32():
    return _params()


def _tokens(cfg, shape, seed=SEED):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("which", ["norm", "rope", "ffn"])
def test_layers_match(f32, which):
    jcfg, jp, cfg, tp = f32
    rng = np.random.default_rng(1)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    lp_t = transformer.unstack(tp["layers"])[0]
    if which == "norm":
        x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32) * 3
        got = layers.apply_norm(cfg, lp_t["ln1"], torch.from_numpy(x))
        want = j_layers.apply_norm(jcfg, lp_j["ln1"], jnp.asarray(x))
    elif which == "rope":
        x = rng.normal(size=(2, 16, cfg.n_heads,
                             cfg.resolved_head_dim)).astype(np.float32)
        pos = np.arange(1000, 1016)[None, :]  # far positions: large angles
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                cfg.rope_theta)
        want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                   jcfg.rope_theta)
    else:
        x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
        got = layers.apply_ffn(cfg, lp_t["ffn"], torch.from_numpy(x))
        want = j_layers.apply_ffn(jcfg, lp_j["ffn"], jnp.asarray(x))
    _close(got, want, what=which)


def test_gqa_forward_matches(f32):
    jcfg, jp, cfg, tp = f32
    x = np.random.default_rng(2).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    got = attention.gqa_forward(cfg, transformer.unstack(tp["layers"])[1]
                                ["attn"], torch.from_numpy(x))
    want = j_attention.gqa_forward(
        jcfg, jax.tree_util.tree_map(lambda a: a[1], jp["layers"])["attn"],
        jnp.asarray(x))
    _close(got, want)


def test_forward_logits_match(f32):
    jcfg, jp, cfg, tp = f32
    toks = _tokens(cfg, (2, 16))
    got, aux = registry.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    want, _ = j_registry.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    assert got.shape == (2, 16, cfg.padded_vocab) and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("window", [0, 16])
def test_prefill_then_decode_match(f32, window):
    """Prefill 12 tokens, then 8 decode steps on fixed tokens; with a
    16-slot window the ring buffer wraps at position 16."""
    jcfg, jp, cfg, tp = f32
    b, s, steps = 2, 12, 8
    prompt, feed = _tokens(cfg, (b, s)), _tokens(cfg, (steps, b), seed=5)
    jstate = j_registry.init_decode_state(jcfg, b, s + steps + 1,
                                          window=window)
    tstate = registry.init_decode_state(cfg, b, s + steps + 1, window=window,
                                        device="cpu")
    before = dict(_build.launches)
    got, tstate = transformer.prefill(cfg, tp, torch.from_numpy(prompt),
                                      tstate, window=window)
    want, jstate = j_transformer.prefill(jcfg, jp, jnp.asarray(prompt),
                                         jstate, window=window)
    _close(got, want, what="prefill logits")
    assert tstate["pos"] == int(jstate["pos"]) == s
    for name in ("k", "v"):
        _close(tstate["cache"][name][:, :, :s],
               np.asarray(jstate["cache"][name])[:, :, :s],
               what=f"prefill cache {name}")
    for i in range(steps):
        got, tstate = registry.decode_step(cfg, tp, tstate,
                                           torch.from_numpy(feed[i]),
                                           window=window)
        want, jstate = j_registry.decode_step(jcfg, jp, jstate,
                                              jnp.asarray(feed[i]),
                                              window=window)
        _close(got, want, what=f"decode step {i}")
    for name in ("k", "v"):
        _close(tstate["cache"][name], jstate["cache"][name],
               what=f"cache {name} after decode")
    assert _build.launches == before  # CPU tensors: no kernel


def test_generate_matches(f32):
    jcfg, jp, cfg, tp = f32
    prompts, gen_len = _tokens(cfg, (2, 12)), 8
    want = np.asarray(JLLMServer(jcfg, jp).generate(jnp.asarray(prompts),
                                                    gen_len))
    server = LLMServer(cfg, tp, device="cpu")
    got = server.generate(torch.from_numpy(prompts), gen_len)
    assert got.dtype == torch.int32 and got.shape == (2, gen_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert server.stats.requests == 2 and server.stats.candidates == 16
    # the JAX logits behind every greedy choice: the top two must differ by
    # more than the logit tolerance for equal tokens to mean something
    state = j_registry.init_decode_state(jcfg, 2, 12 + gen_len + 1)
    lg, state = j_transformer.prefill(jcfg, jp, jnp.asarray(prompts), state)
    for i in range(gen_len):
        lg = np.asarray(lg)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        assert margin > TOL * float(np.abs(lg).max()) + TOL * float(
            np.abs(top2).max()), f"step {i}: top-2 margin {margin}"
        np.testing.assert_array_equal(lg.argmax(-1), want[:, i])
        lg, state = j_registry.decode_step(jcfg, jp, state,
                                           jnp.asarray(want[:, i]))


def test_bf16_weights_cross_bit_for_bit_and_prefill_matches():
    jcfg, jp, cfg, tp = _params("bfloat16")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16
        back = convert.params_to_numpy(node)
        assert back.dtype == np.int16
        np.testing.assert_array_equal(back.view(ml_dtypes.bfloat16),
                                      np.asarray(leaf))
    b, s = 2, 12
    prompt = _tokens(cfg, (b, s))
    got, tstate = transformer.prefill(
        cfg, tp, torch.from_numpy(prompt),
        registry.init_decode_state(cfg, b, s + 1, device="cpu"))
    want, jstate = j_transformer.prefill(
        jcfg, jp, jnp.asarray(prompt),
        j_registry.init_decode_state(jcfg, b, s + 1))
    assert got.dtype == torch.bfloat16
    _close(got, want, tol=3e-2, what="bf16 prefill logits")
    for name in ("k", "v"):
        _close(tstate["cache"][name][:, :, :s],
               np.asarray(jstate["cache"][name], np.float32)[:, :, :s],
               tol=3e-2, what=f"bf16 prefill cache {name}")


def test_port_decode_matches_its_forward(f32):
    """``test_archs.py``'s decode-vs-forward bound, inside the port."""
    _, _, cfg, tp = f32
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(cfg, (b, s), seed=2))
    full, _ = registry.forward(cfg, tp, {"tokens": toks})
    state = registry.init_decode_state(cfg, b, s, device="cpu")
    outs = []
    for i in range(s):
        lg, state = registry.decode_step(cfg, tp, state, toks[:, i])
        outs.append(lg)
    dec = torch.stack(outs, 1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 5e-3, rel


def _spec_leaves(tree, prefix=()):
    if pspec.is_spec(tree):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _spec_leaves(tree[k], prefix + (k,))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_full_width_param_specs_match(arch):
    jcfg, cfg = j_registry.get_config(arch), registry.get_config(arch)
    theirs = {tuple(p.key for p in path): s for path, s in
              jax.tree_util.tree_flatten_with_path(
                  j_registry.param_specs(jcfg),
                  is_leaf=j_pspec.is_spec)[0]}
    ours = dict(_spec_leaves(registry.param_specs(cfg)))
    assert sorted(ours) == sorted(theirs)
    for path, s in ours.items():
        t = theirs[path]
        assert (s.shape, s.axes, s.init, s.fan_in) == \
            (t.shape, t.axes, t.init, t.fan_in), path
        assert str(s.dtype).removeprefix("torch.") == jnp.dtype(t.dtype).name
    assert pspec.count(registry.param_specs(cfg)) == \
        j_pspec.count(j_registry.param_specs(jcfg))
    # fan_in survives the stacking: wq's is d_model, not its head count
    # (every family but the attention-free ssm has a wq, and MLA, whose
    # query goes through wdq and wuq; MLA's wo keeps H * v_head_dim)
    wq = [s for path, s in ours.items() if path[-1] == "wq"]
    assert bool(wq) == (cfg.family != "ssm" and cfg.attn_kind != "mla")
    assert all(s.fan_in == cfg.d_model for s in wq)
    if cfg.attn_kind == "mla":
        wo = ours[("layers", "attn", "wo")]
        assert wo.fan_in == cfg.n_heads * cfg.v_head_dim


@pytest.mark.parametrize("what", ["q_lora_rank=0", "family=rnn",
                                  "moe_impl=expert_parallel"])
def test_unported_archs_and_families_raise(what):
    key, value = what.split("=")
    phi = registry.get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    if key == "moe_impl":  # needs a mesh: raises where the FFN runs
        cfg = phi.replace(moe_impl=value)
        params = registry.init_params(cfg, 0, "cpu")
        with pytest.raises(ValueError,
                           match="expert_parallel.*needs a device mesh"):
            registry.forward(cfg, params,
                             {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
        return
    # MLA's direct query projection (no config sets it) on deepseek-v2
    base = (registry.get_config("deepseek-v2-236b", smoke=True)
            if key == "q_lora_rank" else llama32_1b.smoke())
    value = int(value) if value.isdigit() else value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.param_specs(base.replace(**{key: value}))
