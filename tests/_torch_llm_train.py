"""Shared checks of the port's LLM training path against the JAX package on
the CPU (``tests/test_torch_llm_train.py`` and
``tests/test_torch_llm_train_families.py`` run them per arch id).

Each arch id's ``smoke()`` config (f32) gets the JAX package's
``init_params(PRNGKey(0))`` weights, carried into the port by
``convert.params_from_numpy``. Leaves that initialize to one constant
(norm scales, biases, LoRA's ``b``, the SSM's ``a_log`` / ``d_skip`` /
``dt_bias``) would leave parts of the gradient trivially zero or equal, so
both sides get the same seeded values for them. The batch is the port's
``lm_batches`` (the JAX package's stream), B = 2, S = 16, with three labels
masked (-1); ``encdec`` adds seeded frames (B, 16, d_model).

Tolerance: ``TOL`` = 1e-4 of each compared tensor's largest |value|: two f32
computations of the same function whose sums run in other orders (the port's
attention materializes the scores where the JAX models' jnp flash runs
chunks). The gradients are held per leaf; a train step's weights are not,
since Adam's first step moves each weight by about lr times the sign of its
gradient, and a last-bit gradient difference near 0 flips that sign.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import registry as j_registry
from repro.optim import make_optimizer as j_make_optimizer
from repro.train.steps import make_prefill_step as j_make_prefill_step
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.data.synthetic import lm_batches
from repro_torch.kernels import _build
from repro_torch.models import moe, registry
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.steps import make_prefill_step, make_train_step

SEED = 0
TOL = 1e-4
B, S, LR, STEPS = 2, 16, 1e-3, 3


def close(got, want, what, tol=TOL):
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * float(np.abs(want).max(initial=0.0)), (what, err)


def _seed_constant_leaves(node, rng):
    """In place: every float leaf whose values are all one constant c gets
    c + N(0, 0.2) (c != 0) or N(0, 0.05) (c == 0)."""
    for name, leaf in node.items():
        if isinstance(leaf, dict):
            _seed_constant_leaves(leaf, rng)
        elif leaf.size > 1 and np.all(leaf == leaf.flat[0]):
            c = float(leaf.flat[0])
            noise = rng.normal(0, 0.2 if c else 0.05, leaf.shape)
            node[name] = (c + noise).astype(leaf.dtype)


def setup(arch, **overrides):
    """(JAX config, JAX params, port config, port params on the CPU, batch
    as numpy arrays); ``overrides`` replace config fields on both sides
    (``remat``, ``remat_policy``)."""
    jcfg = j_registry.get_config(arch, smoke=True).replace(**overrides)
    cfg = registry.get_config(arch, smoke=True).replace(**overrides)
    tree = jax.tree_util.tree_map(
        np.asarray, j_registry.init_params(jcfg, jax.random.PRNGKey(SEED)))
    _seed_constant_leaves(tree, np.random.default_rng(7))
    batch = next(lm_batches(cfg.vocab_size, B, S, 1, seed=3))
    batch["labels"][0, :2] = -1
    batch["labels"][1, -1] = -1
    if cfg.family == "encdec":
        batch["frames"] = np.random.default_rng(4).normal(
            size=(B, S, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jp, cfg, convert.params_from_numpy(tree, "cpu"), batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _router_gaps(cfg, probs):
    """The gap between each token's k-th and (k+1)-th router probability,
    and the largest probability."""
    top = np.sort(np.asarray(probs, np.float32), axis=-1)[:, ::-1]
    return top[:, cfg.top_k - 1] - top[:, cfg.top_k], float(top.max())


def check_loss_and_grads(arch, monkeypatch, **overrides):
    """``registry.loss_fn``'s loss, ce and aux and every leaf's gradient
    (autograd) against ``jax.value_and_grad`` of JAX's ``loss_fn``, both
    configs with ``overrides``."""
    jcfg, jp, cfg, tp, batch = setup(arch, **overrides)
    routed = []
    router = moe._router

    def recording(*a):
        routed.append(router(*a))
        return routed[-1]

    monkeypatch.setattr(moe, "_router", recording)
    before = dict(_build.launches)
    leaves = {k: v for k, v in _leaves(tp)}
    for t in leaves.values():
        t.requires_grad_()
    loss, metrics = registry.loss_fn(cfg, tp, _torch_batch(batch))
    forward_routed = list(routed)  # a remat backward routes again
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    assert _build.launches == before  # CPU tensors: no kernel

    def jloss(p):
        return j_registry.loss_fn(jcfg, p, _jax_batch(batch))

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    close(loss, jl, "loss")
    close(metrics["ce"], jm["ce"], "ce")
    close(metrics["aux"], jm["aux"], "aux")
    assert float(metrics["ce"].detach()) > 0
    assert np.isfinite(float(loss.detach()))
    if cfg.is_moe:
        assert float(metrics["aux"].detach()) > 0
        # every routed token stands away from a tie between its k-th and
        # (k+1)-th expert, so equal routing means something
        assert len(forward_routed) == cfg.n_layers
        for _, _, probs in forward_routed:
            gaps, top = _router_gaps(cfg, probs.detach().numpy())
            assert float(gaps.min()) > 2 * TOL * top, gaps.min()
    jleaves = dict(_leaves(jp))
    jgrads = dict(_leaves(jg))
    assert list(jleaves) == list(leaves)
    n_nonzero = 0
    for (name, t), g in zip(leaves.items(), grads):
        want = np.asarray(jgrads[name], np.float32)
        got = torch.zeros_like(t) if g is None else g
        close(got, want, f"grad {name}")
        n_nonzero += bool(np.abs(want).max() > 0)
    # the seeded leaves leave no gradient trivially zero
    assert n_nonzero == len(leaves), (n_nonzero, len(leaves))


def check_train_steps(arch):
    """``make_train_step`` (Adam, lr 1e-3) three times on one batch: losses
    finite and falling; with JAX's params and Adam state handed across
    before each step, each step's loss, ce and aux equal JAX's."""
    jcfg, jp, cfg, tp, batch = setup(arch)
    opt = make_optimizer("adam", lr=LR)
    step_fn = make_train_step(cfg, opt)
    tb = _torch_batch(batch)
    params, state, step, losses = tp, opt.init(tp), 0, []
    for _ in range(STEPS):
        params, state, step, m = step_fn(params, state, step, tb)
        losses.append(float(m["loss"]))
    assert step == STEPS
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"{arch}: loss did not decrease: {losses}"
    # the twin: JAX's state into the port before each step
    jopt = j_make_optimizer("adam", lr=LR)
    jstep_fn = jax.jit(j_make_train_step(jcfg, jopt))
    jparams, jstate, jstep = jp, jopt.init(jp), jnp.zeros((), jnp.int32)
    jb = _jax_batch(batch)
    for i in range(STEPS):
        tparams = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        tstate = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jstate), "cpu")
        _, _, nxt, m = step_fn(tparams, tstate, i, tb)
        jparams, jstate, jstep, jm = jstep_fn(jparams, jstate, jstep, jb)
        assert nxt == int(jstep) == i + 1
        for key in ("loss", "ce", "aux"):
            close(m[key], jm[key], f"step {i} {key}")


def check_prefill_step(arch):
    """``make_prefill_step``'s last-position logits against JAX's."""
    jcfg, jp, cfg, tp, batch = setup(arch)
    batch = {k: v for k, v in batch.items() if k != "labels"}
    got = make_prefill_step(cfg)(tp, _torch_batch(batch))
    want = jax.jit(j_make_prefill_step(jcfg))(jp, _jax_batch(batch))
    assert got.shape == (B, cfg.padded_vocab) and got.grad_fn is None
    close(got, want, "prefill logits")
