"""Optimizers as (init, update) pairs over nested dicts of tensors (port of
``repro/optim/optimizers.py``).

* ``adagrad`` — what Fwumious Wabbit / VW run online (power-t scheduling,
  the paper's hyperparameter search). State: the accumulator.
* ``adam`` — the substrate default for the LLM architectures. State: (m, v).

``update`` is functional, as in the JAX package: it returns new trees and
leaves its arguments alone. The trainer writes the results back into its own
tensors (``train/pipeline.py``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts that share one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _unzip(tree, n: int):
    """A tree whose leaves are n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: _unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tree


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    # an f32 0-d tensor on the leaf's device: ``float / tensor`` would
    # multiply by the reciprocal, where the JAX package divides
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# the most weights of one leaf that Adam updates at once: each leaf is
# updated in slices along its first dim, of as many rows as fit in this many
# weights (one row at least), into its new tensors, so that the f32
# temporaries (the gradient, the corrected moments, the step) are a
# slice's, not the leaf's (the layer stacks: qwen2.5-3b's FFN leaf holds
# 0.81 G weights); elementwise, the bits do not depend on the slicing
ADAM_CHUNK = 1 << 26


def adam(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": _map(zeros, params), "v": _map(zeros, params)}

    def update(grads, state, params, step):
        def upd(g, m, v, p, c1, c2, out_p, out_m, out_v):
            """Writes the new p, m and v into ``out_p`` / ``out_m`` /
            ``out_v``; ``c1`` / ``c2`` the bias corrections."""
            g = g.to(torch.float32)
            m = torch.add(b1 * m, (1 - b1) * g, out=out_m)
            v = torch.add(b2 * v, (1 - b2) * g * g, out=out_v)
            delta = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(torch.float32)
            # computed in f32, rounded to p's dtype as it is written
            torch.sub(p.to(torch.float32), lr * delta, out=out_p)

        def leaf(g, m, v, p):
            t = torch.as_tensor(step, device=p.device).to(torch.float32) + 1.0
            c1 = 1 - torch.pow(_scalar(b1, p), t)
            c2 = 1 - torch.pow(_scalar(b2, p), t)
            new = (torch.empty_like(p), torch.empty_like(m),
                   torch.empty_like(v))
            rows = [x if x.dim() else x[None] for x in (g, m, v, p) + new]
            n = rows[3].shape[0]
            per = max(1, ADAM_CHUNK // max(1, p.numel() // max(1, n)))
            for i in range(0, n, per):
                upd(*(x[i:i + per] for x in rows[:4]), c1, c2,
                    *(x[i:i + per] for x in rows[4:]))
            return new

        new_p, new_m, new_v = _unzip(
            _map(leaf, grads, state["m"], state["v"], params), 3)
        return new_p, {"m": new_m, "v": new_v}

    return Optimizer(init, update)


ADAGRAD_POWER_T = 0.5  # classic AdaGrad
ADAGRAD_EPS = 1e-10


def adagrad(lr: float = 0.1) -> Optimizer:
    """FW/VW-style AdaGrad with power-t learning-rate scaling.

    effective_lr = lr / (acc + eps)**power_t, the accumulator starting at 0.
    The JAX package's ``power_t``, ``eps`` and ``initial_acc`` arguments are
    the constants above here: no port caller changes them.
    """

    def init(params):
        return {"acc": _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)}

    def update(grads, state, params, step):
        def upd(g, a, p):
            g = g.to(torch.float32)
            a = a + g * g
            scale = _scalar(lr, a) / torch.pow(a + ADAGRAD_EPS, ADAGRAD_POWER_T)
            return (p.to(torch.float32) - scale * g).to(p.dtype), a

        new_p, new_a = _unzip(_map(upd, grads, state["acc"], params), 2)
        return new_p, {"acc": new_a}

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adam":
        return adam(**kw)
    if name == "adagrad":
        return adagrad(**kw)
    raise ValueError(name)
