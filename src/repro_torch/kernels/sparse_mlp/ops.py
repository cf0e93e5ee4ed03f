"""The §4.3 block-skip weight gradient through the kernel (port of
``repro/kernels/sparse_mlp/ops.py``).

:func:`sparse_weight_grad` computes ``dW = xᵀ · g_masked``. A CPU tensor
gets the plain version (``ref.py``); a CUDA tensor gets K10 in
``csrc/sparse_mlp.cu`` or an exception. Unlike the Pallas wrapper nothing is
padded and no block size is chosen here: the kernel masks ragged tiles and
fixes its own tiling.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparse_mlp.ref import sparse_weight_grad_ref


def sparse_weight_grad(x: torch.Tensor, g_masked: torch.Tensor
                       ) -> torch.Tensor:
    """(B, I) f32, (B, J) f32 on one device -> (I, J) f32. On the card a
    (batch block, column tile) whose ``g_masked`` block is all zero is
    skipped and adds exactly 0, even where ``x`` is not finite."""
    if x.dim() != 2 or g_masked.dim() != 2 or x.shape[0] != g_masked.shape[0]:
        raise ValueError(f"x (B, I) and g_masked (B, J) must share B, got "
                         f"{tuple(x.shape)} and {tuple(g_masked.shape)}")
    if x.device != g_masked.device:
        raise ValueError(f"x on {x.device}, g_masked on {g_masked.device}")
    if not x.is_cuda:
        return sparse_weight_grad_ref(x, g_masked)
    _build.check(x, "x", torch.float32)
    _build.check(g_masked, "g_masked", torch.float32)
    (b, i), j = x.shape, g_masked.shape[1]
    out = torch.empty((i, j), dtype=torch.float32, device=x.device)
    if out.numel():
        _build.launch("sparse_weight_grad", x.data_ptr(), g_masked.data_ptr(),
                      out.data_ptr(), b, i, j)
    return out
