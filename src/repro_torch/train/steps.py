"""Step factories over the model registry (port of ``repro/train/steps.py``).

``train_step`` differentiates :func:`registry.loss_fn` with autograd: every
attention call of the forward goes through the flash ``FlashAttention``
function (K11 with its log-sum-exp, then K13 and K12 in the backward, on the
card). With ``rt`` on a mesh (``common/runtime.py``) ``make_train_step``
gives the sharded step, the port of what the JAX package gets from
``jax.jit`` over sharded arguments. ``cfg.remat`` is not ported: it saves
memory and changes no number.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.common import runtime
from repro_torch.launch import sharding
from repro_torch.models import moe, registry
from repro_torch.optim.optimizers import Optimizer


def _leaves(tree, prefix=()):
    """(path, tensor) pairs of a nested dict in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves replaced, in :func:`_leaves`'s
    order, by the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    return next(leaves)


def loss_and_grads(cfg, params, batch, *, window: Optional[int] = None):
    """``registry.loss_fn`` at ``params`` and its gradient by autograd:
    ``(loss, {"ce", "aux"}, grads)``, the loss and metrics detached, grads a
    tree like ``params`` (a leaf the loss never reads gets zeros, as
    ``jax.grad`` gives it). ``params`` is left alone."""
    flat = [t.detach().requires_grad_() for _, t in _leaves(params)]
    with torch.enable_grad():
        loss, metrics = registry.loss_fn(cfg, _rebuild(params, iter(flat)),
                                         batch, window=window)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _rebuild(params, iter(grads)))


def make_train_step(cfg, optimizer: Optimizer, rt=None, *,
                    window: Optional[int] = None):
    """``train_step(params, opt_state, step, batch) -> (params', opt',
    step + 1, {"loss", "ce", "aux"})``, as in the JAX package. ``step`` is
    a Python int (Adam's bias correction counts from it); the metrics are
    detached 0-d f32 tensors. ``params`` and ``opt_state`` are left alone:
    the optimizer returns new trees. With ``rt`` on a mesh, the sharded
    step: every rank calls it on its shards of ``params`` and ``opt_state``
    and the global batch, gets :func:`sharded_loss_and_grads`' global
    metrics and gradient shards, and runs the optimizer shard-local (Adam
    is elementwise), as the JAX package's ``jit`` over sharded arguments
    does."""
    sharded = rt is not None and rt.mesh is not None

    def train_step(params, opt_state, step: int, batch):
        if sharded:
            loss, metrics, grads = sharded_loss_and_grads(
                cfg, params, batch, rt, window=window)
        else:
            loss, metrics, grads = loss_and_grads(cfg, params, batch,
                                                  window=window)
        new_params, new_opt = optimizer.update(grads, opt_state, params, step)
        return new_params, new_opt, step + 1, {"loss": loss, **metrics}

    return train_step


def sharded_loss_and_grads(cfg, params, batch, rt, *,
                           window: Optional[int] = None):
    """:func:`loss_and_grads` on every rank of ``rt``'s mesh, called alike
    by all: ``(loss, {"ce", "aux"}, grads)``, the global loss and metrics on
    every rank and ``grads`` this rank's shard of each leaf's global
    gradient.

    ``params`` are this rank's shards of every leaf (``sharding.local_tree``
    under ``param_shardings``); ``batch`` is the global batch, of which the
    rank takes its rows (``batch_spec``: split over the data axes, or whole
    where the batch does not divide). Each leaf is gathered whole before
    the forward, so every kernel sees plain contiguous tensors, except that
    expert-parallel MoE layers keep their expert leaves' model-axis slices,
    as the JAX package's ``shard_map`` does. The rank differentiates its
    share of the global loss: its rows' cross-entropy weighted by their
    labels' share of all labels and divided by the number of ranks that
    hold the same rows, plus the (global) aux term divided by the rank
    count. Summing each leaf's gradient over the ranks that used it whole
    (every rank; the data axes for expert slices) gives the global
    gradient, of which the rank keeps its shard."""
    specs = sharding.param_shardings(cfg, registry.param_axes(cfg),
                                     registry.param_specs(cfg), rt.mesh)
    paths = [path for path, _ in _leaves(params)]
    spec_list = []
    for path in paths:
        node = specs
        for key in path:
            node = node[key]
        spec_list.append(node)
    tokens = batch["tokens"].numel()
    bspecs = sharding.batch_shardings(batch, rt.mesh)
    split = bspecs["tokens"][0] is not None
    step_rt = dataclasses.replace(rt, batch_split=split)
    batch = {k: sharding.local_shard(v, bspecs[k], rt)
             for k, v in batch.items()}
    copies = rt.axis_size((rt.model_axis,)) if split else rt.n_devices
    ep = cfg.is_moe and moe.resolve_impl(
        cfg, tokens, step_rt) == "expert_parallel"
    keeps = [(rt.model_axis,) if ep and path[-2:-1] == ("moe",)
             and path[-1] in moe.EXPERT_LEAVES and rt.model_axis in s
             else () for path, s in zip(paths, spec_list)]
    with torch.no_grad():
        full = [sharding.gather(t, s, rt, keep).detach().requires_grad_()
                for (_, t), s, keep in zip(_leaves(params), spec_list, keeps)]
    with torch.enable_grad():
        _, metrics = registry.loss_fn(cfg, _rebuild(params, iter(full)),
                                      batch, step_rt, window=window)
        n_mine = (batch["labels"] >= 0).sum().float()
        n_all = runtime.psum(n_mine, rt, rt.all_axes) / copies
        ce_share = metrics["ce"] * (n_mine / n_all.clamp_min(1.0) / copies)
        mine = ce_share + cfg.router_aux_coef * metrics["aux"] / rt.n_devices
        grads = torch.autograd.grad(mine, full, allow_unused=True)
    local = []
    for t, g, s, keep in zip(full, grads, spec_list, keeps):
        g = torch.zeros_like(t) if g is None else g.contiguous()
        dist.all_reduce(g, group=rt.group(
            tuple(a for a in rt.all_axes if a not in keep)))
        local.append(sharding.local_shard(g, s, rt, keep))
    loss, ce = runtime.psum(torch.stack([mine, ce_share]).detach(), rt,
                            rt.all_axes)
    return (loss, {"ce": ce, "aux": metrics["aux"].detach()},
            _rebuild(params, iter(local)))


def make_prefill_step(cfg, *, window: Optional[int] = None):
    """Inference prefill: the full forward's last-position logits (B, V).
    The port's forward has no ``last_only``: the whole sequence's logits are
    computed and the last position taken."""

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = registry.forward(cfg, params, batch, window=window)
        return logits[:, -1]

    return prefill_step


def make_serve_step(cfg, *, window: int = 0):
    """One-token greedy decode step: ``(params, state, tokens (B,)) ->
    (next tokens (B,) int32, new state)``."""

    def serve_step(params, state, tokens):
        logits, new_state = registry.decode_step(cfg, params, state, tokens,
                                                 window=window)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_state

    return serve_step
