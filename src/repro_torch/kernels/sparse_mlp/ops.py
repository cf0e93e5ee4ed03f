"""The §4.3 block-skip weight gradient through the kernel (port of
``repro/kernels/sparse_mlp/ops.py``).

:func:`sparse_weight_grad` computes ``dW = xᵀ · g_masked``. A CPU tensor
gets the plain version (``ref.py``); a CUDA tensor gets K10 in
``csrc/sparse_mlp.cu`` or an exception. Unlike the Pallas wrapper nothing is
padded and no block size is chosen here: the kernel masks ragged tiles and
fixes its own tiling. Every call books its work (:func:`k10_work`) with an
op counter (``launch/op_analysis.py``) through ``_build.booking``, which
computes it only while a counter is open; a meta tensor gets its output
allocated and nothing else (the dry run).
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
    with _build.booking("sparse_weight_grad",
                        lambda: k10_work(x.shape, g_masked.shape)):
        return _call(x, g_masked)


def k10_work(x_shape, g_shape):
    """(operations, bytes) K10's function needs: 2 I operations per element
    of g, every element counted (the dense count: which blocks the kernel
    skips depends on g's zeros, which a count from shapes cannot see); x
    and g read and dW written, f32."""
    (b, i), j = x_shape, g_shape[1]
    return 2 * b * i * j, 4 * (b * i + b * j + i * j)


def _call(x: torch.Tensor, g_masked: torch.Tensor) -> torch.Tensor:
    if x.is_meta:
        return x.new_empty((x.shape[1], g_masked.shape[1]))
    if not x.is_cuda:  # contiguous, as K10's output is
        return sparse_weight_grad_ref(x, g_masked).contiguous()
    _build.check(x, "x", torch.float32)
    _build.check(g_masked, "g_masked", torch.float32)
    (b, i), j = x.shape, g_masked.shape[1]
    out = torch.empty((i, j), dtype=torch.float32, device=x.device)
    if out.numel():
        _build.launch("sparse_weight_grad", x.data_ptr(), g_masked.data_ptr(),
                      out.data_ptr(), b, i, j)
    return out
