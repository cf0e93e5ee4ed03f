"""The port's SSM family (mamba2-130m, ``models/ssm.py``) against the JAX
package on the CPU.

At ``smoke()`` size in f32 with the JAX package's ``init_params(PRNGKey(0))``
weights carried into the port by ``convert.params_from_numpy``; ``norm``,
``a_log``, ``d_skip``, ``dt_bias``, ``conv_b`` and the RMSNorm scales
initialize to constants, which would test nothing, so both sides get the
same seeded values for them. Tolerance: rtol 1e-5 and atol 1e-5 of the
largest |value| (``tests/test_torch_llm_families.py``'s ``TOL``):

* the configs equal JAX's field for field;
* ``softplus`` equals ``jax.nn.softplus`` (``logaddexp(x, 0)``) where
  torch's thresholded one does not;
* ``_causal_conv``, ``ssd_chunked`` (S = 16, one chunk; 20, padded to two;
  7, below one chunk) and ``mamba_forward`` on seeded inputs;
* ``mamba_decode`` step by step against JAX's, the conv window and the SSM
  state included, and the state written in place;
* ``forward`` (``test_archs.py::test_smoke_forward_shapes_no_nan``'s twin:
  shapes, no NaN, and JAX's logits); decode step by step against JAX's,
  and the port's decode against its own forward within
  ``test_archs.py::test_decode_matches_forward``'s rel < 5e-3;
* ``LLMServer.generate`` returns JAX's tokens (the stepwise warm-up, as
  JAX's server), with every step's top-2 logit margin in JAX above the
  logit tolerance;
* bf16 weights cross bit for bit, and the bf16 decode runs;
* ``python -m repro_torch.launch.serve --arch mamba2-130m --smoke --device
  cpu`` runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import mamba2_130m as j_mamba2
from repro.models import registry as j_registry
from repro.models import ssm as j_ssm
from repro.serving.server import LLMServer as JLLMServer
from repro_torch import convert
from repro_torch.common.config import ModelConfig
from repro_torch.configs import mamba2_130m as mamba2
from repro_torch.kernels import _build
from repro_torch.launch import serve as serve_cli
from repro_torch.models import registry, ssm
from repro_torch.serving.server import LLMServer

ARCH = "mamba2-130m"
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
    """In place, every leaf that initializes to a constant: scales and the
    SSM ``norm`` / ``d_skip`` 1 + N(0, 0.2); ``conv_b`` / ``dt_bias`` / LoRA's
    ``b`` N(0, 0.2); ``a_log`` N(0, 0.5)."""
    for name, leaf in node.items():
        if isinstance(leaf, dict):
            seed_constant_leaves(leaf, rng)
        elif name in ("scale", "norm", "d_skip"):
            node[name] = (1.0 + rng.normal(0, 0.2, leaf.shape)).astype(
                leaf.dtype)
        elif name in ("conv_b", "dt_bias", "b"):
            node[name] = rng.normal(0, 0.2, leaf.shape).astype(leaf.dtype)
        elif name == "a_log":
            node[name] = rng.normal(0, 0.5, leaf.shape).astype(leaf.dtype)


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


@pytest.mark.parametrize("make,make_ref", [
    (mamba2.config, j_mamba2.config), (mamba2.smoke, j_mamba2.smoke)],
    ids=["config", "smoke"])
def test_config_matches_reference(make, make_ref):
    cfg, ref = make(), make_ref()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg == ModelConfig(**dataclasses.asdict(ref))
    for prop in ("d_inner", "n_ssm_heads", "padded_vocab"):
        assert getattr(cfg, prop) == getattr(ref, prop), prop
    assert ARCH in registry.ARCH_IDS
    assert registry.get_config(ARCH, smoke=make is mamba2.smoke) == cfg


def test_constant_leaves_are_seeded(f32):
    _, _, _, tp = f32
    mixer = tp["layers"]["mixer"]
    for name in ("norm", "a_log", "d_skip", "dt_bias", "conv_b"):
        assert float(mixer[name].std()) > 0.1, name
    assert float(tp["ln_f"]["scale"].std()) > 0.1


def test_softplus_is_jaxs():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [-1e3, -88.5, 19.99, 20.0, 20.01, 1e3]]).astype(
        np.float32)
    got = ssm.softplus(torch.from_numpy(x))
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # torch's own returns x itself above its threshold of 20, JAX's not
    assert not np.array_equal(
        torch.nn.functional.softplus(torch.from_numpy(x)).numpy(), want)


def test_causal_conv_matches(f32):
    jcfg, jp, cfg, tp = f32
    mixer, jmixer = _layer(tp["layers"]["mixer"]), _layer(jp["layers"]["mixer"])
    conv_dim = mixer["conv_w"].shape[1]
    u = np.random.default_rng(3).normal(size=(B, 13, conv_dim)).astype(
        np.float32)
    got = ssm._causal_conv(mixer["conv_w"], mixer["conv_b"],
                           torch.from_numpy(u))
    want = j_ssm._causal_conv(jmixer["conv_w"], jmixer["conv_b"],
                              jnp.asarray(u))
    _close(got, want, what="causal conv")
    # causal: the first output sees only the first input
    u2 = u.copy()
    u2[:, 1:] += 1.0
    got2 = ssm._causal_conv(mixer["conv_w"], mixer["conv_b"],
                            torch.from_numpy(u2))
    torch.testing.assert_close(got2[:, 0], got[:, 0], rtol=0, atol=0)


@pytest.mark.parametrize("s", [16, 20, 7], ids=["one-chunk", "padded",
                                                "below-chunk"])
def test_ssd_chunked_matches(f32, s):
    _, _, cfg, _ = f32
    rng = np.random.default_rng(s)
    h, p = cfg.n_ssm_heads, cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    x = rng.normal(size=(B, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(0, 0.5, h)).astype(np.float32)
    bm = rng.normal(size=(B, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(B, s, g, n)).astype(np.float32)
    got = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)),
                          cfg.ssm_chunk)
    want = j_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)),
                             cfg.ssm_chunk)
    assert got.shape == (B, s, h, p) and bool(torch.isfinite(got).all())
    _close(got, want, what=f"ssd_chunked S={s}")


def test_mamba_forward_matches(f32):
    jcfg, jp, cfg, tp = f32
    x = np.random.default_rng(4).normal(size=(B, 20, cfg.d_model)).astype(
        np.float32)
    got = ssm.mamba_forward(cfg, _layer(tp["layers"]["mixer"]),
                            torch.from_numpy(x))
    want = j_ssm.mamba_forward(jcfg, _layer(jp["layers"]["mixer"]),
                               jnp.asarray(x))
    _close(got, want, what="mamba_forward")


def test_mamba_decode_matches_step_by_step(f32):
    """Each step's output and the whole state against JAX's; the port's
    state tensors are the ones it was given, written in place."""
    jcfg, jp, cfg, tp = f32
    mixer, jmixer = _layer(tp["layers"]["mixer"]), _layer(jp["layers"]["mixer"])
    xs = np.random.default_rng(5).normal(size=(9, B, 1, cfg.d_model)).astype(
        np.float32)
    state = ssm.init_mamba_state(cfg, B, "cpu")
    jstate = j_ssm.init_mamba_state(jcfg, B)
    conv, ssm_state = state["conv"], state["ssm"]
    assert conv.dtype == torch.float32 and ssm_state.dtype == torch.float32
    for i, x in enumerate(xs):
        got, state = ssm.mamba_decode(cfg, mixer, torch.from_numpy(x), state)
        want, jstate = j_ssm.mamba_decode(jcfg, jmixer, jnp.asarray(x), jstate)
        _close(got, want, what=f"step {i}")
        _close(state["conv"], jstate["conv"], what=f"conv state {i}")
        _close(state["ssm"], jstate["ssm"], what=f"ssm state {i}")
        assert state["conv"] is conv and state["ssm"] is ssm_state


def test_forward_matches(f32):
    jcfg, jp, cfg, tp = f32
    s = 20  # two chunks of 16, the second padded
    toks = _tokens(cfg, (B, s))
    before = dict(_build.launches)
    got, aux = registry.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    want, jaux = j_registry.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    assert got.shape == (B, s, cfg.padded_vocab) and got.dtype == torch.float32
    assert not bool(torch.isnan(got).any())
    _close(got, want, what="logits")
    assert float(aux) == float(jaux) == 0.0
    assert _build.launches == before  # no kernel on this path


def test_decode_matches_step_by_step(f32):
    jcfg, jp, cfg, tp = f32
    steps = 12
    feed = _tokens(cfg, (steps, B), seed=5)
    state = registry.init_decode_state(cfg, B, steps, device="cpu")
    jstate = j_registry.init_decode_state(jcfg, B, steps)
    jdecode = _jax_decode(jcfg)
    for i in range(steps):
        got, state = registry.decode_step(cfg, tp, state,
                                          torch.from_numpy(feed[i]))
        want, jstate = jdecode(jp, jstate, jnp.asarray(feed[i]))
        assert state["pos"] == int(jstate["pos"]) == i + 1
        _close(got, want, what=f"decode step {i}")
    for name in ("conv", "ssm"):
        assert state["cache"][name].shape[0] == cfg.n_layers
        _close(state["cache"][name], jstate["cache"][name], what=name)


def test_port_decode_matches_its_forward(f32):
    """``test_archs.py::test_decode_matches_forward``'s contract (rel <
    5e-3) inside the port, across a chunk boundary."""
    _, _, cfg, tp = f32
    s = 20
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


def test_generate_matches(f32):
    jcfg, jp, cfg, tp = f32
    prompts, gen_len = _tokens(cfg, (B, 10)), 8
    want = np.asarray(JLLMServer(jcfg, jp).generate(jnp.asarray(prompts),
                                                    gen_len))
    server = LLMServer(cfg, tp, device="cpu")
    got = server.generate(torch.from_numpy(prompts), gen_len)
    assert got.dtype == torch.int32 and got.shape == (B, gen_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert server.stats.requests == B and server.stats.candidates == B * gen_len
    # JAX's server warms up step by step (no batched prefill for ssm); the
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
        want_dt = (torch.float32 if path[-1].key in ("a_log", "d_skip",
                                                     "dt_bias")
                   else torch.bfloat16)
        assert node.dtype == want_dt, path
        got = convert.params_to_numpy(node)
        if want_dt == torch.bfloat16:
            got = got.view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(got, np.asarray(leaf))
    # the bf16 decode runs: the conv window in bf16, the SSM state in f32
    state = registry.init_decode_state(cfg, B, 4, device="cpu")
    assert state["cache"]["conv"].dtype == torch.bfloat16
    assert state["cache"]["ssm"].dtype == torch.float32
    lg, state = registry.decode_step(cfg, tp, state,
                                     torch.zeros(B, dtype=torch.int32))
    assert lg.shape == (B, cfg.padded_vocab) and bool(torch.isfinite(lg).all())


def test_serve_launcher_runs_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--batch", "2", "--gen", "4"]) == 0
    assert f"{ARCH} on cpu: 2x4 tokens" in capsys.readouterr().out
