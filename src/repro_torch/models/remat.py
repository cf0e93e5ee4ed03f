"""Activation rematerialization of a layer stack's body (the port of the
JAX package's ``jax.checkpoint(body, policy=...)`` around each stack's
scanned body).

:func:`checkpointed` wraps a body in non-reentrant
``torch.utils.checkpoint.checkpoint`` when ``cfg.remat`` is set and grad
mode is on; otherwise it returns the body unchanged, so a forward that is
not differentiated (serving, the prefill and decode steps) dispatches the
ops it always did, as ``jax.checkpoint`` leaves such a forward alone.

* ``cfg.remat_policy == "nothing"`` saves the region's inputs only: the
  backward runs the body's forward again.
* Any other policy is JAX's ``dots_with_no_batch_dims_saveable``: the
  outputs of the products with no batch dimension are kept, everything
  else is recomputed. The bodies compute every such product through
  :func:`matmul` (an (..., k) activation by a (k, n) weight), and every
  batched one (the MoE's experts and combine, the SSD scan, attention)
  otherwise: the policy is read off the call, not off the aten op, which
  cannot tell the two apart (an ``einsum`` without a batch dimension
  dispatches ``bmm`` with a batch of one; a 2-d by 3-d ``matmul`` folds
  into one ``mm``).

In a dots region's forward :func:`matmul` keeps a detached alias of its
``mm``'s output; in the recompute in the backward each call takes the
kept output back in order, a dispatch mode over the call's one ``mm``
answering with it (autograd still records the product, saving its
inputs), and lets it go. A kept product that no tensor saved for the
backward follows is dropped when the region's forward ends: the
recompute stops at the last tensor it needs (non-reentrant checkpoint's
early stop) and would never reach it. That is the product whose output
only the body's closing residual add reads (the FFN's down projection of
a dense layer, the mamba mixer's out projection), which JAX's partial
evaluation leaves out of the residuals as dead code. The saved tensors
are counted by wrapping checkpoint's own pack hook for the region's
forward (``torch._C._autograd._top_saved_tensors_default_hooks``; a torch
without it raises: remat has no fallback).
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint, noop_context_fn

aten = torch.ops.aten

# the dots region this thread runs (its forward or its recompute), if any
_active = threading.local()


class _Region:
    """One dots region's kept products."""

    def __init__(self):
        self.kept: List[Optional[torch.Tensor]] = []
        self.reached = 0  # kept products a saved tensor follows
        self.next = 0  # the recompute's next product


class _Forward:
    """The region's forward: :func:`matmul` keeps its outputs, and each
    tensor saved for the backward marks the products before it reached."""

    def __init__(self, region: _Region):
        self.region = region

    def __enter__(self):
        pack, unpack = torch._C._autograd._top_saved_tensors_default_hooks(
            False)
        region = self.region

        def counting_pack(t):
            region.reached = len(region.kept)
            return pack(t)

        self._hooks = torch.autograd.graph.saved_tensors_hooks(counting_pack,
                                                               unpack)
        self._hooks.__enter__()
        self._outer = getattr(_active, "state", None)
        _active.state = (region, True)
        return self

    def __exit__(self, *exc):
        _active.state = self._outer
        self._hooks.__exit__(*exc)
        del self.region.kept[self.region.reached:]


class _Recompute:
    """The recompute: :func:`matmul` replays the kept outputs."""

    def __init__(self, region: _Region):
        self.region = region

    def __enter__(self):
        self._outer = getattr(_active, "state", None)
        _active.state = (self.region, False)
        return self

    def __exit__(self, *exc):
        _active.state = self._outer


class _Answer(TorchDispatchMode):
    """Answers the one ``mm`` of a replayed :func:`matmul` with ``kept``,
    not running it (the ops that save its inputs run)."""

    def __init__(self, kept: torch.Tensor):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is not aten.mm.default:
            return func(*args, **(kwargs or {}))
        if self.kept is None:
            raise RuntimeError("remat: a replayed matmul ran two products")
        out, self.kept = self.kept, None
        return out


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(x, w)`` for a no-batch product of an (..., k)
    activation by a (k, n) weight: the product JAX's dots policy saves,
    kept and replayed inside a dots region (see the module's docstring),
    a plain ``torch.matmul`` anywhere else. In a region it runs as
    ``matmul`` folds it, one ``mm`` of x's rows, so that the ``mm``'s own
    output is what is kept."""
    state = getattr(_active, "state", None)
    if state is None or not torch.is_grad_enabled():
        return torch.matmul(x, w)
    region, forward = state
    if not forward and region.next >= len(region.kept):
        return torch.matmul(x, w)  # past the dropped tail
    rows = x.reshape(-1, x.shape[-1])
    if forward:
        y = torch.mm(rows, w)
        region.kept.append(y.detach())
    else:
        answer = _Answer(region.kept[region.next])
        region.kept[region.next] = None
        region.next += 1
        with answer:
            y = torch.mm(rows, w)
        if answer.kept is not None:
            raise RuntimeError("remat: a replayed matmul ran no product")
    return y.view(*x.shape[:-1], w.shape[-1])


def _dots_contexts():
    region = _Region()
    return _Forward(region), _Recompute(region)


def checkpointed(cfg, body: Callable) -> Callable:
    """``body`` as a rematerialized region under ``cfg.remat`` /
    ``cfg.remat_policy`` (see the module's docstring); ``body`` itself when
    ``cfg.remat`` is false or grad mode is off. The region takes its
    arguments positionally."""
    if not cfg.remat or not torch.is_grad_enabled():
        return body
    context_fn = (noop_context_fn if cfg.remat_policy == "nothing"
                  else _dots_contexts)

    def region(*args):
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)

    return region
