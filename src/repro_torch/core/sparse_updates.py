"""Sparse weight updates via ReLU zero-global-gradient skipping (paper §4.3;
port of ``repro/core/sparse_updates.py``).

With f(x) = max(x, 0), whole branches of the backward computation are
provably zero and can be identified upfront, before any weight update.

* :func:`relu_linear` — linear + ReLU whose backward applies the activation
  mask before the weight-gradient product (algebraically the autograd
  gradient; equivalence-tested).
* :func:`masked_weight_grad` — ``dW = xᵀ (g * mask)``, always through
  ``kernels/sparse_mlp/ops.py``: on the card the block-skip kernel K10,
  which skips every (batch block, column tile) whose masked gradient is all
  zero; on the CPU its plain version, the einsum of the JAX package's
  ``use_kernel=False``. The JAX training path computes the einsum because
  its Pallas kernel would run in interpret mode there; the port has the
  kernel on the card, so the device picks the route.
* :func:`skip_stats` / :func:`skip_stats_from_col_alive` — the measured
  zero-gradient structure (units and tiles with zero global gradient) and
  the modeled update speedup behind the paper's Table 3.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.kernels.sparse_mlp import ops as sk_ops


def masked_weight_grad(x: torch.Tensor, g_masked: torch.Tensor
                       ) -> torch.Tensor:
    """dW = xᵀ @ g_masked (K10 on CUDA tensors, the einsum on CPU ones)."""
    return sk_ops.sparse_weight_grad(x.contiguous(), g_masked.contiguous())


class _ReluLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        y = torch.relu(x @ w + b)
        # the mask y > 0 is taken from the saved output in backward
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        gm = g * (y > 0).to(g.dtype)  # the upfront zero-global-gradient mask
        dw = masked_weight_grad(x, gm).to(w.dtype)
        return gm @ w.T, dw, gm.sum(dim=0)


def relu_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """``relu(x @ w + b)`` with the §4.3 masked backward."""
    return _ReluLinear.apply(x, w, b)


def sparse_mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
                     n_layers: int) -> torch.Tensor:
    """ReLU MLP whose hidden layers use the sparse-update backward."""
    for i in range(n_layers):
        x = relu_linear(x, params[f"w{i}"], params[f"b{i}"])
    return x @ params[f"w{n_layers}"] + params[f"b{n_layers}"]


def _stats(skipped_units: int, total: int, skipped_tiles: int,
           total_tiles: int) -> Dict[str, float]:
    unit_frac = skipped_units / max(total, 1)
    tile_frac = skipped_tiles / max(total_tiles, 1)
    return {
        "unit_skip_frac": unit_frac,
        "tile_skip_frac": tile_frac,
        "modeled_update_speedup": 1.0 / max(1.0 - unit_frac, 1e-6),
        "modeled_tpu_tile_speedup": 1.0 / max(1.0 - tile_frac, 1e-6),
    }


def skip_stats_from_col_alive(col_alive: List, block: int = 128
                              ) -> Dict[str, float]:
    """:func:`skip_stats` from per-update column-alive reductions.

    ``col_alive``: per hidden layer, (M, H) booleans — for each of M weight
    updates, whether unit h had any live activation in that update's batch
    (what the trainer copies to the host once per round). Fractions are
    aggregated over all M updates.
    """
    total = skipped_units = total_tiles = skipped_tiles = 0
    for ca in col_alive:
        ca = np.asarray(ca, bool)
        if ca.ndim == 1:
            ca = ca[None]
        m, h = ca.shape
        total += m * h
        skipped_units += int((~ca).sum())
        nb = -(-h // block)
        cap = np.pad(ca, ((0, 0), (0, nb * block - h)), constant_values=False)
        tiles_alive = np.any(cap.reshape(m, nb, block), axis=2)
        total_tiles += m * nb
        skipped_tiles += int((~tiles_alive).sum())
    return _stats(skipped_units, total, skipped_tiles, total_tiles)


def skip_stats(masks: List[torch.Tensor], block: int = 128
               ) -> Dict[str, float]:
    """Zero-global-gradient structure across a batch.

    masks: per hidden layer, (B, H) boolean activation masks (y > 0). A
    *unit* is skippable if its column is all-zero across the batch; a
    *tile* if a (block x block) gradient tile is all-zero. Modeled speedup =
    dense update FLOPs / non-skipped update FLOPs (the paper's Table 3).
    """
    return skip_stats_from_col_alive(
        [torch.as_tensor(m).any(dim=0).cpu().numpy() for m in masks], block)
