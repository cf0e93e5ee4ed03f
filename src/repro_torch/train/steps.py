"""Step factories over the model registry (port of ``repro/train/steps.py``).

``train_step`` differentiates :func:`registry.loss_fn` with autograd: every
attention call of the forward goes through the flash ``FlashAttention``
function (K11 with its log-sum-exp, then K13 and K12 in the backward, on the
card). With ``rt`` on a mesh (``common/runtime.py``) each factory gives
the sharded step, the port of what the JAX package gets from ``jax.jit``
over sharded arguments: SPMD by hand, every weight gathered whole, each
rank on its rows of the batch (``sharding.batch_spec``), the train step's
optimizer state held in ZeRO-1 slices (:func:`init_opt_state`) and the
decode state in ``decode_state_shardings``' slices. The dry run
(``launch/dryrun_lib.py``) counts these steps at the production meshes.
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


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _param_specs(cfg, rt):
    return sharding.param_shardings(cfg, registry.param_axes(cfg),
                                    registry.param_specs(cfg), rt.mesh)


def zero1_specs(cfg, rt):
    """The optimizer state's spec tree (each leaf's ``zero1_shardings``
    spec), for ``sharding.gather_tree`` / ``local_tree`` of a state."""
    return sharding.zero1_shardings(_param_specs(cfg, rt),
                                    registry.param_specs(cfg), rt.mesh)


class _Layout:
    """What the sharded steps read of ``(cfg, rt)`` alone, computed once by
    their factories, per parameter leaf by its path (a tree of parameters
    may hold its leaves in another order than ``registry.param_specs``):
    ``specs``, its ``param_shardings`` spec; ``zero1``, the spec of the
    rank's ZeRO-1 slice within its parameter shard (the data axes
    ``zero1_shardings`` adds, on the dim it adds them to, a dim the
    parameter spec leaves whole; None elsewhere); ``keeps(ep)``, the axes a
    gather leaves split: the model axis for an expert leaf of an
    expert-parallel MoE layer, as the JAX package's ``shard_map`` keeps
    it."""

    def __init__(self, cfg, rt):
        tree = _param_specs(cfg, rt)
        z1 = sharding.zero1_shardings(tree, registry.param_specs(cfg),
                                      rt.mesh)
        self.specs = dict(_leaves(tree))
        self.zero1 = {path: tuple(z if p is None else None
                                  for p, z in zip(s, _at(z1, path)))
                      for path, s in self.specs.items()}
        self._ep_keeps = {
            path: (rt.model_axis,) if path[-2:-1] == ("moe",)
            and path[-1] in moe.EXPERT_LEAVES and rt.model_axis in s
            else () for path, s in self.specs.items()}
        self._no_keeps = dict.fromkeys(self.specs, ())

    def keeps(self, ep: bool):
        return self._ep_keeps if ep else self._no_keeps


def init_opt_state(cfg, optimizer: Optimizer, params, rt=None):
    """``optimizer.init`` for the step :func:`make_train_step` gives: on
    ``params`` without a mesh; with one, on each leaf's ZeRO-1 slice of the
    rank's parameter shards (``params``)."""
    if rt is None or rt.mesh is None:
        return optimizer.init(params)
    zero1 = _Layout(cfg, rt).zero1
    return optimizer.init(_rebuild(params, iter(
        sharding.local_shard(t, zero1[path], rt)
        for path, t in _leaves(params))))


def make_train_step(cfg, optimizer: Optimizer, rt=None, *,
                    window: Optional[int] = None):
    """``train_step(params, opt_state, step, batch) -> (params', opt',
    step + 1, {"loss", "ce", "aux"})``, as in the JAX package. ``step`` is
    a Python int (Adam's bias correction counts from it); the metrics are
    detached 0-d f32 tensors. ``params`` and ``opt_state`` are left alone:
    the optimizer returns new trees. With ``rt`` on a mesh, the sharded
    step: every rank calls it on its shards of ``params``, its ZeRO-1
    slices of ``opt_state`` (:func:`init_opt_state`) and the global batch,
    and gets :func:`sharded_loss_and_grads`' global metrics and gradient
    shards. ZeRO-1: the rank runs the optimizer on its slice over the data
    axes of its gradient and parameter shards (where ``zero1_shardings``
    adds the data axes to a leaf), then all-gathers the updated slices over
    the data axes into its new parameter shard. Adam is elementwise, so
    the parameters equal those of the optimizer run on whole shards bit for
    bit."""
    sharded = rt is not None and rt.mesh is not None
    layout = _Layout(cfg, rt) if sharded else None

    def train_step(params, opt_state, step: int, batch):
        if sharded:
            loss, metrics, grads = sharded_loss_and_grads(
                cfg, params, batch, rt, window=window, layout=layout)
            extra = layout.zero1

            def sliced(tree):
                return _rebuild(tree, iter(
                    sharding.local_shard(t, extra[path], rt)
                    for path, t in _leaves(tree)))

            new_slices, new_opt = optimizer.update(
                sliced(grads), opt_state, sliced(params), step)
            new_params = _rebuild(params, iter(
                sharding.gather(t, extra[path], rt)
                for path, t in _leaves(new_slices)))
        else:
            loss, metrics, grads = loss_and_grads(cfg, params, batch,
                                                  window=window)
            new_params, new_opt = optimizer.update(grads, opt_state, params,
                                                   step)
        return new_params, new_opt, step + 1, {"loss": loss, **metrics}

    return train_step


def _rows(batch, rt):
    """The rank's rows of a global batch (``batch_spec``: split over the
    data axes, or whole where the batch does not divide), and the step's
    runtime saying which."""
    bspecs = sharding.batch_shardings(batch, rt.mesh)
    split = bspecs["tokens"][0] is not None
    rows = {k: sharding.local_shard(v, bspecs[k], rt)
            for k, v in batch.items()}
    return rows, dataclasses.replace(rt, batch_split=split)


def _gathered(cfg, params, rt, step_rt, tokens: int, layout: _Layout):
    """Every leaf of the rank's shards gathered whole (``sharding.gather``;
    a collective), except that expert-parallel MoE layers keep their
    expert leaves' model-axis slices, as the JAX package's ``shard_map``
    does. Returns ``(full leaves, specs, keeps)`` in :func:`_leaves`'
    order."""
    keep_of = layout.keeps(cfg.is_moe and moe.resolve_impl(
        cfg, tokens, step_rt) == "expert_parallel")
    leaves = list(_leaves(params))
    spec_list = [layout.specs[path] for path, _ in leaves]
    keeps = [keep_of[path] for path, _ in leaves]
    with torch.no_grad():
        full = [sharding.gather(t, s, rt, keep)
                for (_, t), s, keep in zip(leaves, spec_list, keeps)]
    return full, spec_list, keeps


def sharded_loss_and_grads(cfg, params, batch, rt, *,
                           window: Optional[int] = None,
                           layout: Optional[_Layout] = None):
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
    gradient, of which the rank keeps its shard. ``layout``: the specs
    :func:`make_train_step` computed once (computed here if not given)."""
    tokens = batch["tokens"].numel()
    batch, step_rt = _rows(batch, rt)
    copies = (rt.axis_size((rt.model_axis,)) if step_rt.batch_split
              else rt.n_devices)
    layout = layout or _Layout(cfg, rt)
    full, spec_list, keeps = _gathered(cfg, params, rt, step_rt, tokens,
                                       layout)
    full = [t.detach().requires_grad_() for t in full]
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


def make_prefill_step(cfg, rt=None, *, window: Optional[int] = None):
    """Inference prefill: ``prefill_step(params, batch) -> (B, V)``, the
    forward's last-position logits (``last_only``: no (B, S, V) logits).
    With ``rt`` on a mesh, each rank calls it on its parameter shards and
    the global batch: every weight is gathered whole (expert-parallel MoE
    layers keep their expert slices), the rank takes its rows
    (``batch_spec``) and gets their logits; the MoE layers see ``rt``."""
    sharded = rt is not None and rt.mesh is not None
    layout = _Layout(cfg, rt) if sharded else None

    def prefill_step(params, batch):
        with torch.no_grad():
            if not sharded:
                logits, _ = registry.forward(cfg, params, batch,
                                             window=window, last_only=True)
                return logits[:, -1]
            tokens = batch["tokens"].numel()
            rows, step_rt = _rows(batch, rt)
            full, _, _ = _gathered(cfg, params, rt, step_rt, tokens,
                                   layout)
            logits, _ = registry.forward(
                cfg, _rebuild(params, iter(full)), rows, step_rt,
                window=window, last_only=True)
        return logits[:, -1]

    return prefill_step


def make_serve_step(cfg, rt=None, *, window: int = 0, state_specs=None):
    """One-token greedy decode step: ``(params, state, tokens (B,)) ->
    (next tokens (B,) int32, new state)``; the cache is written in place.

    With ``rt`` on a mesh, each rank calls it on its parameter shards, its
    slices of the decode state and the global tokens; ``state_specs`` is
    the state's spec tree (``sharding.decode_state_shardings`` of the
    global state). Every weight is gathered whole; the rank takes its rows
    of the tokens (``batch_spec``); each state leaf is gathered along its
    splits but the data axes holding those rows, the step runs on the
    rank's rows, and the new state is written back into the rank's slices.
    The rank gets its rows' next tokens. The decode step's MoE runs dense;
    where the JAX package's "auto" rule would pick expert-parallel (B
    divisible by the rank count) the sharded step raises, so that the two
    never differ silently."""
    sharded = rt is not None and rt.mesh is not None
    if sharded and state_specs is None:
        raise ValueError("a sharded serve step needs state_specs "
                         "(sharding.decode_state_shardings)")
    layout = _Layout(cfg, rt) if sharded else None

    def serve_step(params, state, tokens):
        if not sharded:
            logits, new_state = registry.decode_step(
                cfg, params, state, tokens, window=window)
            return torch.argmax(logits, dim=-1).to(torch.int32), new_state
        if cfg.is_moe and moe.resolve_impl(
                cfg, tokens.numel(), rt) == "expert_parallel":
            raise NotImplementedError(
                "the sharded decode step's MoE runs dense; the 'auto' rule "
                f"picks expert-parallel for {tokens.numel()} tokens on "
                f"{rt.n_devices} ranks")
        tspec = sharding.batch_spec(tuple(tokens.shape), rt.mesh)
        keep = rt.data_axes if tspec[0] is not None else ()
        rows = sharding.local_shard(tokens, tspec, rt)
        full, _, _ = _gathered(cfg, params, rt, rt, tokens.numel(), layout)

        def gather(t, spec):
            if not isinstance(t, torch.Tensor):  # pos, a Python int
                return t
            return sharding.gather(t, spec, rt, keep)

        def back(shard, out, spec):
            if not isinstance(shard, torch.Tensor):
                return out
            if out is not shard:
                shard.copy_(sharding.local_shard(out, spec, rt, keep))
            return shard

        with torch.no_grad():
            mine = sharding.map_tree(gather, state, state_specs)
            logits, new = registry.decode_step(
                cfg, _rebuild(params, iter(full)), mine, rows,
                window=window)
            new_state = sharding.map_tree(back, state, new, state_specs)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_state

    return serve_step

