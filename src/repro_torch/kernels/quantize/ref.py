"""Plain PyTorch versions of the 16-bit wire-quantization kernels.

``w_min`` and ``bucket`` arrive as Python floats and are rounded to f32,
as ``jnp.float32(...)`` rounds them in the JAX package. They enter the
arithmetic as 0-d tensors on ``w``'s device: PyTorch's CUDA division by a
host scalar multiplies by its reciprocal, which would move codes off
``_quantize_core``'s."""
from __future__ import annotations

import torch

B_MAX = 2**16


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def minmax_ref(w: torch.Tensor) -> torch.Tensor:
    """(n,) f32 -> (2,) f32 ``[min, max]``; NaN propagates."""
    return torch.stack([torch.min(w), torch.max(w)])


def quantize_codes_ref(w: torch.Tensor, w_min: float, bucket: float
                       ) -> torch.Tensor:
    """(n,) f32 -> (n,) int16 holding the uint16 codes
    ``clip(round_half_even((w - w_min) / bucket), 0, 65535)``."""
    q = torch.round((w - _f32(w_min, w)) / _f32(bucket, w))
    return torch.clamp(q, 0, B_MAX - 1).to(torch.int32).to(torch.int16)


def dequantize_codes_ref(q: torch.Tensor, w_min: float, bucket: float
                         ) -> torch.Tensor:
    """(n,) int16 uint16 codes -> (n,) f32 ``w_min + float(q) * bucket``
    (a multiply, then an add: two roundings, as numpy's decode)."""
    qf = torch.bitwise_and(q.to(torch.int32), 0xFFFF).to(torch.float32)
    return torch.add(_f32(w_min, q), torch.mul(qf, _f32(bucket, q)))
