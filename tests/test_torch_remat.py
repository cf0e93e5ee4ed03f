"""Activation rematerialization (``repro_torch/models/remat.py``) against
the port without it, on the CPU, for every arch id's ``smoke()`` config
(f32):

* under each policy (``"dots"``, JAX's ``dots_with_no_batch_dims_saveable``,
  and ``"nothing"``), ``steps.loss_and_grads`` with ``remat=True`` gives the
  loss, ce, aux and every leaf's gradient of ``remat=False`` bit for bit:
  non-reentrant checkpointing rebuilds the same autograd graph from the same
  values;
* a remat step's backward runs the checkpointed bodies again (the flash
  kernel's wrapper is called twice per attention layer);
* under ``torch.no_grad()`` the forward with ``remat=True`` dispatches the
  op list of ``remat=False`` (``op_analysis.Counter``'s per-op record), and
  ``remat.checkpointed`` returns the body itself;
* the dots regions keep no product whose output no later op saves a
  tensor for (the closing residual's addend).
"""
import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import lm_batches
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.op_analysis import Counter
from repro_torch.models import registry, remat
from repro_torch.train import steps

POLICIES = ("dots", "nothing")
B, S = 2, 16


def _setup(arch, **overrides):
    cfg = registry.get_config(arch, smoke=True).replace(**overrides)
    params = registry.init_params(cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             next(lm_batches(cfg.vocab_size, B, S, 1, seed=3)).items()}
    batch["labels"][0, :2] = -1
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(np.random.default_rng(4).normal(
            size=(B, S, cfg.d_model)).astype(np.float32))
    return cfg, params, batch


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_remat_gradients_equal_no_remat_bit_for_bit(arch, policy):
    cfg, params, batch = _setup(arch)
    loss0, m0, g0 = steps.loss_and_grads(cfg.replace(remat=False), params,
                                         batch)
    loss1, m1, g1 = steps.loss_and_grads(
        cfg.replace(remat=True, remat_policy=policy), params, batch)
    assert torch.equal(loss1, loss0)
    assert m1.keys() == m0.keys()
    for k in m0:
        assert torch.equal(m1[k], m0[k]), k
    leaves0, leaves1 = dict(steps._leaves(g0)), dict(steps._leaves(g1))
    assert leaves1.keys() == leaves0.keys()
    for path, g in leaves0.items():
        assert torch.equal(leaves1[path], g), path
    assert any(bool(g.abs().max() > 0) for g in leaves0.values())


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_backward_runs_the_attention_again(policy, monkeypatch):
    """K11's wrapper: once per layer in the forward, and once more per
    layer in a remat backward (never without remat)."""
    calls = []
    k11 = fa_ops._k11

    def counting(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return k11(*a, **kw)

    monkeypatch.setattr(fa_ops, "_k11", counting)
    for on, per_layer in ((False, 1), (True, 2)):
        cfg, params, batch = _setup("llama3.2-1b", remat=on,
                                    remat_policy=policy)
        calls.clear()
        steps.loss_and_grads(cfg, params, batch)
        assert len(calls) == per_layer * cfg.n_layers


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_no_grad_forward_dispatches_the_same_ops(arch):
    cfg, params, batch = _setup(arch)
    counts = []
    for on in (False, True):
        c = cfg.replace(remat=on, remat_policy="dots")
        with torch.no_grad(), Counter() as counter:
            logits, _ = registry.forward(c, params, batch)
        counts.append((dict(counter.ops), counter.n_ops, counter.flops,
                       counter.bytes, counter.peak_bytes, logits))
    (ops0, n0, f0, b0, p0, l0), (ops1, n1, f1, b1, p1, l1) = counts
    assert ops1 == ops0 and (n1, f1, b1, p1) == (n0, f0, b0, p0)
    assert torch.equal(l1, l0)


def test_checkpointed_is_the_body_without_remat_or_grad():
    cfg = registry.get_config("llama3.2-1b", smoke=True)

    def body(x):
        return x

    assert remat.checkpointed(cfg.replace(remat=False), body) is body
    with torch.no_grad():
        assert remat.checkpointed(cfg.replace(remat=True), body) is body
    assert remat.checkpointed(cfg.replace(remat=True), body) is not body


def test_dots_region_keeps_only_products_the_backward_reaches(monkeypatch):
    """y = x + (relu(x @ w1) @ w2): the first product is kept and replayed;
    the second, read only by the closing add, is dropped at the region's
    end and never run again. The gradients equal plain autograd's."""
    kept = []
    exit_ = remat._Forward.__exit__

    def recording(self, *exc):
        out = exit_(self, *exc)
        kept.append([tuple(t.shape) for t in self.region.kept])
        return out

    monkeypatch.setattr(remat._Forward, "__exit__", recording)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, generator=g, requires_grad=True)
    w1 = torch.randn(8, 16, generator=g, requires_grad=True)
    w2 = torch.randn(16, 8, generator=g, requires_grad=True)

    def body(x, w1, w2):
        return x + remat.matmul(torch.relu(remat.matmul(x, w1)), w2)

    cfg = registry.get_config("llama3.2-1b", smoke=True).replace(remat=True)
    want = torch.autograd.grad(body(x, w1, w2).square().sum(), (x, w1, w2))
    with Counter() as c:
        y = remat.checkpointed(cfg, body)(x, w1, w2)
        n_fwd = c.ops["aten.mm.default"][0]
        got = torch.autograd.grad(y.square().sum(), (x, w1, w2))
    assert kept == [[(3, 16)]]
    assert n_fwd == 2
    # the backward: four gradient products, no product run again
    assert c.ops["aten.mm.default"][0] == 2 + 4
    for a, b in zip(got, want):
        assert torch.equal(a, b)
