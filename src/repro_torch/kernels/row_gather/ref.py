"""Plain PyTorch version of the row-gather-and-dequantize kernel."""
from __future__ import annotations

import torch


def gather_dequant_rows_q8_ref(codes, scale, zero, idx):
    """codes: (V, ...) int8; scale/zero: (V,) f32; idx: any int shape
    -> f32 ``idx.shape + codes.shape[1:]``."""
    shape = tuple(idx.shape) + (1,) * (codes.dim() - 1)
    c = codes[idx].to(torch.float32)
    return c * scale[idx].reshape(shape) + zero[idx].reshape(shape)
