"""Weights across the package boundary: numpy trees <-> port tensors.

The JAX package's params (converted leaf by leaf with ``np.asarray``) and the
port's share one tree layout: nested dicts whose leaves are arrays, int8
row-quantized tables ``{"codes", "scale", "zero"}`` and blocked-LR tables
``{"codes", "scale", "zero", "block"}``. :func:`params_from_numpy` moves such
a tree onto a device unchanged in value, so both packages compute on the
same weights; :func:`params_to_numpy` is its inverse, so weights (or
optimizer state) trained by the port can be handed back.

bf16 leaves cross as their bits: numpy has no bfloat16 of its own (the JAX
package's arrays carry ``ml_dtypes``' type, named ``"bfloat16"``, which
``torch.from_numpy`` refuses), so such a leaf is read through an ``int16``
view and a bf16 tensor goes back as its ``int16`` view; the caller rebuilds
the bf16 array with ``.view(ml_dtypes.bfloat16)``.
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
        arr = np.array(node, copy=True)
        if arr.dtype.name == "bfloat16":  # bit for bit through int16
            return torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(arr).to(dev)

    return walk(tree)


def params_to_numpy(tree):
    """Tensor tree -> numpy tree on the host (the inverse of
    :func:`params_from_numpy`); ints stay ints, dtypes are kept, except that
    a bf16 tensor comes back as its ``int16`` bits."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return tree


def to_device(tree, device: torch.device):
    """Move every tensor leaf of a params tree to ``device`` (a no-op for
    leaves already there)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree

