"""Weights across the package boundary: numpy trees <-> port tensors.

The JAX package's params (converted leaf by leaf with ``np.asarray``) and the
port's share one tree layout: nested dicts whose leaves are arrays, int8
row-quantized tables ``{"codes", "scale", "zero"}`` and blocked-LR tables
``{"codes", "scale", "zero", "block"}``. :func:`params_from_numpy` moves such
a tree onto a device unchanged in value, so both packages compute on the
same weights; :func:`params_to_numpy` is its inverse, so weights (or
optimizer state) trained by the port can be handed back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device


def params_from_numpy(tree, device: DeviceLike = None):
    """Numpy (or array-like) tree -> tensors on ``device``. Python ints (the
    blocked table's ``"block"``) stay ints; dtypes are kept."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, int):
            return node
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return walk(tree)


def params_to_numpy(tree):
    """Tensor tree -> numpy tree on the host (the inverse of
    :func:`params_from_numpy`); ints stay ints, dtypes are kept."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def to_device(tree, device: torch.device):
    """Move every tensor leaf of a params tree to ``device`` (a no-op for
    leaves already there)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree

