"""Step factories over the model registry (port of ``repro/train/steps.py``).

``train_step`` differentiates :func:`registry.loss_fn` with autograd: every
attention call of the forward goes through the flash ``FlashAttention``
function (K11 with its log-sum-exp, then K13 and K12 in the backward, on the
card). The JAX ``rt`` (a device mesh's runtime) is not ported: distribution
tooling is ROADMAP.md Queue 1 item 9. ``cfg.remat`` is not ported either:
it saves memory and changes no number.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import registry
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


def make_train_step(cfg, optimizer: Optimizer, *,
                    window: Optional[int] = None):
    """``train_step(params, opt_state, step, batch) -> (params', opt',
    step + 1, {"loss", "ce", "aux"})``, as in the JAX package. ``step`` is
    a Python int (Adam's bias correction counts from it); the metrics are
    detached 0-d f32 tensors. ``params`` and ``opt_state`` are left alone:
    the optimizer returns new trees."""

    def train_step(params, opt_state, step: int, batch):
        loss, metrics, grads = loss_and_grads(cfg, params, batch,
                                              window=window)
        new_params, new_opt = optimizer.update(grads, opt_state, params, step)
        return new_params, new_opt, step + 1, {"loss": loss, **metrics}

    return train_step


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
