"""The port's §4.3 sparse backward against the JAX package on the CPU.

* ``kernels/sparse_mlp``: the wrapper on CPU tensors (its plain version)
  against ``sparse_weight_grad_pallas`` in interpret mode on
  ``test_kernels.py``'s sweep (rtol 1e-4, atol 1e-4, the reference's own
  bound), exact zeros for an all-zero gradient, and the wrapper's checks;
* ``core/sparse_updates``: ``relu_linear`` / ``sparse_mlp_apply`` gradients
  against JAX's ``relu_linear(use_kernel=True)`` (the Pallas kernel in
  interpret mode) and against plain autograd (rtol 1e-5, atol 1e-5, as
  ``test_paper_core.py``), and ``skip_stats`` equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_updates as JSU
from repro.kernels.sparse_mlp import ops as j_ops
from repro_torch.core import sparse_updates as SU
from repro_torch.kernels import _build
from repro_torch.kernels.sparse_mlp import ops


def _xg(b, i, j, sparsity, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, i)).astype(np.float32)
    g = rng.normal(size=(b, j)).astype(np.float32)
    g *= rng.random((b, j)) >= sparsity
    return x, g


@pytest.mark.parametrize("B,I,J", [(16, 8, 8), (64, 32, 48), (200, 130, 260),
                                   (128, 128, 128), (33, 257, 65),
                                   (129, 277, 64), (1000, 277, 64)])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 1.0])
def test_sparse_weight_grad_matches_pallas(B, I, J, sparsity):
    x, g = _xg(B, I, J, sparsity, B + I + J)
    before = dict(_build.launches)
    got = ops.sparse_weight_grad(torch.from_numpy(x), torch.from_numpy(g))
    want = np.asarray(j_ops.sparse_weight_grad(jnp.asarray(x), jnp.asarray(g),
                                               block=64))
    assert got.shape == (I, J) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert _build.launches == before  # CPU tensors: the plain version
    if sparsity == 1.0:  # the skip is safe: an all-zero gradient gives zeros
        assert float(got.abs().max()) == 0.0


def test_sparse_weight_grad_main_path_shapes():
    """The two hidden layers of the default DeepFFM at the trainer's batch
    (x (512, 277) / g (512, 64); x (512, 64) / g (512, 32)), a ReLU-like
    half of g masked."""
    for i, j in ((277, 64), (64, 32)):
        x, g = _xg(512, i, j, 0.5, i)
        got = ops.sparse_weight_grad(torch.from_numpy(x), torch.from_numpy(g))
        want = np.asarray(j_ops.sparse_weight_grad(jnp.asarray(x),
                                                   jnp.asarray(g)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_sparse_weight_grad_checks_its_inputs():
    x, g = torch.zeros(4, 3), torch.zeros(5, 2)
    with pytest.raises(ValueError, match="share B"):
        ops.sparse_weight_grad(x, g)
    with pytest.raises(ValueError, match="share B"):
        ops.sparse_weight_grad(torch.zeros(4), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="on"):
        ops.sparse_weight_grad(torch.zeros(4, 3), torch.zeros(4, 2,
                                                              device="meta"))


def _params(seed=2, d=16, h=24):
    rng = np.random.default_rng(seed)
    return {"w0": (rng.normal(size=(d, h)) * 0.5).astype(np.float32),
            "b0": np.zeros(h, np.float32),
            "w1": (rng.normal(size=(h, h)) * 0.5).astype(np.float32),
            "b1": np.zeros(h, np.float32),
            "w2": (rng.normal(size=(h, 1)) * 0.5).astype(np.float32),
            "b2": np.zeros(1, np.float32)}


def _torch_grads(loss_of, p):
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p.items()}
    loss_of(tp).backward()
    return {k: v.grad.numpy() for k, v in tp.items()}


def test_sparse_mlp_grads_equal_autograd_and_jax():
    """Two ReLU layers through ``relu_linear`` (dW on the kernel path):
    gradients equal plain autograd's and the JAX package's sparse MLP."""
    p = _params()
    x = np.random.default_rng(3).normal(size=(32, 16)).astype(np.float32)
    tx = torch.from_numpy(x)

    def dense(tp):
        h = torch.relu(tx @ tp["w0"] + tp["b0"])
        h = torch.relu(h @ tp["w1"] + tp["b1"])
        return torch.sum((h @ tp["w2"] + tp["b2"]) ** 2)

    def sparse(tp):
        return torch.sum(SU.sparse_mlp_apply(tp, tx, 2) ** 2)

    gd, gs = _torch_grads(dense, p), _torch_grads(sparse, p)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    gj = jax.grad(lambda q: jnp.sum(JSU.sparse_mlp_apply(
        q, jnp.asarray(x), 2, use_kernel=True) ** 2))(jp)
    for k in p:
        np.testing.assert_allclose(gs[k], gd[k], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gs[k], np.asarray(gj[k]), rtol=1e-5,
                                   atol=1e-5)


def test_relu_linear_kernel_path_matches_jax():
    """``test_paper_core.py``'s kernel-path case: d/dw sum(relu_linear^2)
    against JAX's ``relu_linear`` with and without the Pallas kernel, and
    the input and bias gradients too."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 48)) * 0.5).astype(np.float32)
    b = rng.normal(0, 0.1, 48).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (x, w, b))
    y = SU.relu_linear(tx, tw, tb)
    torch.sum(y ** 2).backward()
    for use_kernel in (False, True):
        gj = jax.grad(lambda x_, w_, b_: jnp.sum(JSU.relu_linear(
            x_, w_, b_, use_kernel) ** 2), argnums=(0, 1, 2))(
                jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        for got, want in zip((tx.grad, tw.grad, tb.grad), gj):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    want_y = np.maximum(x @ w + b, 0)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("density,h,block", [(0.9, 256, 128), (0.01, 256, 128),
                                             (0.05, 300, 64), (0.0, 20, 8)])
def test_skip_stats_match_reference(density, h, block):
    rng = np.random.default_rng(0)
    masks = [rng.random((64, h)) < density, rng.random((64, h // 2)) < 0.5]
    got = SU.skip_stats([torch.from_numpy(m) for m in masks], block=block)
    want = JSU.skip_stats([jnp.asarray(m) for m in masks], block=block)
    assert got == pytest.approx(want, rel=0, abs=0)
    col_alive = [rng.random((5, h)) < density ** 0.1 for _ in range(2)]
    assert SU.skip_stats_from_col_alive(col_alive, block) == \
        JSU.skip_stats_from_col_alive(col_alive, block)


@pytest.mark.parametrize("sparse_backward", [True, False])
def test_mlp_apply_masks_and_preacts_match_reference(sparse_backward):
    """``deepffm.mlp_apply``'s outputs, activation masks and
    pre-activations against the JAX package's on the same weights."""
    from repro.common.config import FFMConfig as JFFMConfig
    from repro.core import deepffm as jdeepffm
    from repro_torch.common.config import FFMConfig
    from repro_torch.core import deepffm

    cfg = FFMConfig(n_fields=8, context_fields=4, hash_space=2**10, k=4,
                    mlp_hidden=(16, 8))
    jcfg = JFFMConfig(**cfg.__dict__)
    rng = np.random.default_rng(6)
    dims = (cfg.n_pairs + 1,) + cfg.mlp_hidden + (1,)
    p = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"w{i}"] = (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
        p[f"b{i}"] = rng.normal(0, 0.1, b).astype(np.float32)
    x = rng.normal(size=(40, dims[0])).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for kw in ({}, {"return_masks": True}, {"return_preacts": True}):
        got = deepffm.mlp_apply(cfg, tp, torch.from_numpy(x),
                                sparse_backward=sparse_backward, **kw)
        want = jdeepffm.mlp_apply(jcfg, jp, jnp.asarray(x),
                                  sparse_backward=sparse_backward, **kw)
        if not kw:
            got, want = (got, []), (want, [])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-6)
        assert len(got[1]) == len(want[1])
        for g, w in zip(got[1], want[1]):
            if g.dtype == torch.bool:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-6)


def _backward_nodes(t):
    """The class names of the autograd nodes behind ``t``."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


@pytest.mark.parametrize("model", ["mlp", "deepffm"])
def test_only_the_training_surface_takes_the_sparse_backward(model):
    """``forward`` (what the serving engine calls) keeps plain ReLU layers;
    ``loss_fn`` and ``loss_and_aux`` (the trainer's) route the hidden layers
    through ``relu_linear``; ``loss_fn(sparse_backward=False)`` is the
    plain-autograd oracle. All give the same logits."""
    from repro_torch.common.config import FFMConfig
    from repro_torch.core import deepffm
    from repro_torch.data.synthetic import CTRStream

    cfg = FFMConfig(n_fields=8, context_fields=4, hash_space=2**10, k=4,
                    mlp_hidden=(16, 8))
    params = deepffm.init_params(cfg, 0, model, "cpu")
    for leaf in params["mlp"].values():
        leaf.requires_grad_()
    batch = {k: torch.from_numpy(v)
             for k, v in CTRStream(cfg, seed=1).sample(32).items()}
    batch["idx"] = batch["idx"].to(torch.int64)
    fused = "_ReluLinearBackward"
    logits = deepffm.forward(cfg, params, batch["idx"], batch["val"], model)
    assert fused not in _backward_nodes(logits)
    head_in = (torch.randn(32, cfg.n_pairs + 1) if model == "deepffm"
               else torch.randn(32, cfg.n_fields * cfg.k))
    assert fused not in _backward_nodes(deepffm.mlp_apply(
        cfg, params["mlp"], head_in))
    if model == "deepffm":  # the staged engine's head
        assert fused not in _backward_nodes(deepffm.head_from_parts(
            cfg, params, torch.randn(32), torch.randn(32, cfg.n_pairs)))
    loss, aux = deepffm.loss_and_aux(cfg, params, batch, model)
    assert fused in _backward_nodes(loss)
    assert fused in _backward_nodes(deepffm.loss_fn(cfg, params, batch, model))
    assert fused not in _backward_nodes(
        deepffm.loss_fn(cfg, params, batch, model, sparse_backward=False))
    torch.testing.assert_close(aux["logits"], logits, rtol=0, atol=0)
    assert len(aux["masks"]) == len(cfg.mlp_hidden)
