"""The port's hybrid family (zamba2-7b, ``models/hybrid.py``) against the
JAX package on the CPU.

At ``smoke()`` size in f32 (7 positions: 2 super-blocks of period 3 and 1
tail block; the shared block's 4 heads of 32) with the JAX package's
``init_params(PRNGKey(0))`` weights carried into the port by
``convert.params_from_numpy``; the leaves that initialize to constants (the
norms, the SSM's ``a_log`` / ``d_skip`` / ``dt_bias`` / ``conv_b``, and
LoRA's ``b``, whose zeros would leave the LoRA path untested) get the same
seeded values on both sides. Tolerance: rtol 1e-5 and atol 1e-5 of the
largest |value| (``tests/test_torch_llm_families.py``'s ``TOL``):

* the configs equal JAX's field for field;
* ``_shared_block`` (concat, ``w_concat`` plus the LoRA, attention through
  ``flash_attention``'s plain version, FFN, ``w_proj``) on seeded inputs;
* ``forward`` (``test_archs.py::test_smoke_forward_shapes_no_nan``'s twin);
* decode step by step against JAX's, the mamba states and KV caches
  included; the port's decode against its own forward within
  ``test_archs.py::test_decode_matches_forward``'s rel < 5e-3; and
  ``test_archs.py::test_windowed_decode_ring_buffer``'s twin (W = 16);
* ``LLMServer.generate`` returns JAX's tokens, with every step's top-2
  logit margin in JAX above the logit tolerance;
* ``python -m repro_torch.launch.serve --arch zamba2-7b --smoke --device
  cpu`` runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import zamba2_7b as j_zamba2
from repro.models import attention as j_attention
from repro.models import hybrid as j_hybrid
from repro.models import registry as j_registry
from repro.serving.server import LLMServer as JLLMServer
from repro_torch import convert
from repro_torch.common.config import ModelConfig
from repro_torch.configs import zamba2_7b as zamba2
from repro_torch.kernels import _build
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, hybrid, registry
from repro_torch.serving.server import LLMServer
from test_torch_ssm import seed_constant_leaves

ARCH = "zamba2-7b"
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


@pytest.mark.parametrize("make,make_ref", [
    (zamba2.config, j_zamba2.config), (zamba2.smoke, j_zamba2.smoke)],
    ids=["config", "smoke"])
def test_config_matches_reference(make, make_ref):
    cfg, ref = make(), make_ref()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg == ModelConfig(**dataclasses.asdict(ref))
    for prop in ("resolved_head_dim", "d_inner", "n_ssm_heads",
                 "padded_vocab"):
        assert getattr(cfg, prop) == getattr(ref, prop), prop
    assert ARCH in registry.ARCH_IDS
    assert registry.get_config(ARCH, smoke=make is zamba2.smoke) == cfg
    # the shared block's head dim is one of K11's instances, both bodies
    assert cfg.resolved_head_dim in (32, 112)


def test_layout_and_seeded_leaves(f32):
    _, _, cfg, tp = f32
    ns, p = hybrid._n_super(cfg), cfg.attn_period
    assert (ns, hybrid._n_tail(cfg)) == (2, 1)
    assert tp["mamba"]["mixer"]["w_x"].shape[:2] == (ns, p - 1)
    assert tp["lora"]["a"].shape == (ns, 2 * cfg.d_model, cfg.lora_rank)
    assert tp["tail"]["mixer"]["a_log"].shape == (1, cfg.n_ssm_heads)
    assert float(tp["lora"]["b"].std()) > 0.1
    assert float(tp["mamba"]["mixer"]["dt_bias"].std()) > 0.1
    assert float(tp["shared"]["ln1"]["scale"].std()) > 0.1
    with pytest.raises(ValueError, match="lora_rank"):
        hybrid.param_specs(cfg.replace(lora_rank=0))


def test_shared_block_matches(f32):
    jcfg, jp, cfg, tp = f32
    rng = np.random.default_rng(4)
    x, x0 = (rng.normal(size=(B, 12, cfg.d_model)).astype(np.float32)
             for _ in range(2))
    lora = {k: v[1] for k, v in tp["lora"].items()}
    jlora = {k: v[1] for k, v in jp["lora"].items()}
    before = dict(_build.launches)
    got = hybrid._shared_block(
        cfg, tp["shared"], lora, torch.from_numpy(x), torch.from_numpy(x0),
        lambda sp, h: attention.gqa_forward(cfg, sp["attn"], h))
    want = j_hybrid._shared_block(
        jcfg, jp["shared"], jlora, jnp.asarray(x), jnp.asarray(x0),
        lambda sp, h: j_attention.gqa_forward(jcfg, sp["attn"], h, window=0))
    _close(got, want, what="shared block")
    assert _build.launches == before  # CPU tensors: the plain version
    # the LoRA is live: without it the block differs
    zero = {k: torch.zeros_like(v) for k, v in lora.items()}
    bare = hybrid._shared_block(
        cfg, tp["shared"], zero, torch.from_numpy(x), torch.from_numpy(x0),
        lambda sp, h: attention.gqa_forward(cfg, sp["attn"], h))
    assert not torch.allclose(bare, got, atol=1e-3)


def test_forward_matches(f32):
    jcfg, jp, cfg, tp = f32
    s = 20  # two SSD chunks of 16, the second padded
    toks = _tokens(cfg, (B, s))
    got, aux = registry.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    want, jaux = j_registry.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    assert got.shape == (B, s, cfg.padded_vocab) and got.dtype == torch.float32
    assert not bool(torch.isnan(got).any())
    _close(got, want, what="logits")
    assert float(aux) == float(jaux) == 0.0


def test_decode_matches_step_by_step(f32):
    jcfg, jp, cfg, tp = f32
    steps = 10
    feed = _tokens(cfg, (steps, B), seed=5)
    state = registry.init_decode_state(cfg, B, steps, device="cpu")
    jstate = j_registry.init_decode_state(jcfg, B, steps)
    jdecode = _jax_decode(jcfg)
    caches = {k: v for k, v in state["attn"].items()}
    for i in range(steps):
        got, state = registry.decode_step(cfg, tp, state,
                                          torch.from_numpy(feed[i]))
        want, jstate = jdecode(jp, jstate, jnp.asarray(feed[i]))
        assert state["pos"] == int(jstate["pos"]) == i + 1
        _close(got, want, what=f"decode step {i}")
    for group in ("mamba", "attn", "tail"):
        for name, leaf in state[group].items():
            _close(leaf, jstate[group][name], what=f"{group} {name}")
    assert all(state["attn"][k] is v for k, v in caches.items())  # in place


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


def test_windowed_decode_ring_buffer(f32):
    """``test_archs.py::test_windowed_decode_ring_buffer``'s twin: with
    window >= S the ring buffer agrees with the full cache."""
    _, _, cfg, tp = f32
    s, w = 10, 16
    toks = torch.from_numpy(_tokens(cfg, (B, s), seed=3))
    full_state = registry.init_decode_state(cfg, B, s, device="cpu")
    ring_state = registry.init_decode_state(cfg, B, s + w, window=w,
                                            device="cpu")
    assert ring_state["attn"]["k"].shape[2] == w
    for i in range(s):
        lf, full_state = registry.decode_step(cfg, tp, full_state, toks[:, i])
        lr_, ring_state = registry.decode_step(cfg, tp, ring_state,
                                               toks[:, i], window=w)
        rel = float((lf - lr_).abs().max()) / (float(lf.abs().max()) + 1e-9)
        assert rel < 5e-3, f"step {i}: ring/full mismatch {rel}"


def test_generate_matches(f32):
    jcfg, jp, cfg, tp = f32
    prompts, gen_len = _tokens(cfg, (B, 10)), 8
    want = np.asarray(JLLMServer(jcfg, jp).generate(jnp.asarray(prompts),
                                                    gen_len))
    server = LLMServer(cfg, tp, device="cpu")
    got = server.generate(torch.from_numpy(prompts), gen_len)
    assert got.dtype == torch.int32 and got.shape == (B, gen_len)
    np.testing.assert_array_equal(got.numpy(), want)
    # JAX's server warms up step by step (no batched prefill for hybrid);
    # the top two logits behind every greedy choice must differ by more
    # than the logit tolerance for equal tokens to mean something
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


def test_serve_launcher_runs_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--batch", "2", "--gen", "4"]) == 0
    assert f"{ARCH} on cpu: 2x4 tokens" in capsys.readouterr().out
