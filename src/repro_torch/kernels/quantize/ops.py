"""16-bit wire quantization through the kernels (port of
``repro/kernels/quantize/quantize.py``'s three Pallas entry points).

* :func:`minmax` — K7, ``(min, max)`` of a flat f32 array;
* :func:`quantize_codes` — K8, the uint16 codes
  ``clip(round((w - w_min) / bucket), 0, 65535)``, stored as int16;
* :func:`dequantize_codes` — K9, ``w_min + float(q) * bucket``.

A CPU tensor gets the plain version (``ref.py``); a CUDA tensor gets the
kernel in ``csrc/quantize.cu`` or an exception. ``core.quantization``'s
``quantize`` / ``dequantize`` run the two passes through these wrappers.
Unlike the Pallas wrappers nothing is padded: the kernels read the length.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize.ref import (dequantize_codes_ref,
                                              minmax_ref, quantize_codes_ref)

_MINMAX_PARTIALS = 2 * 132 * 8  # csrc/quantize.cu: 2 * kMaxBlocks


def _check_flat(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dim() != 1:
        raise ValueError(f"{name} must be flat (n,), got {tuple(t.shape)}")
    _build.check(t, name, dtype)


def minmax(w: torch.Tensor) -> torch.Tensor:
    """(n,) f32 -> (2,) f32 ``[min, max]`` on ``w``'s device. NaN
    propagates, as ``jnp.min`` / ``jnp.max`` do; an empty array raises."""
    if w.numel() == 0:
        raise ValueError("minmax of an empty array")
    if not w.is_cuda:
        return minmax_ref(w)
    _check_flat(w, "w", torch.float32)
    partials = torch.empty(_MINMAX_PARTIALS, dtype=torch.int32, device=w.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=w.device)
    out = torch.empty(2, dtype=torch.float32, device=w.device)
    _build.launch("minmax", w.data_ptr(), partials.data_ptr(),
                  ticket.data_ptr(), out.data_ptr(), w.numel(),
                  int(w.data_ptr() % 16 == 0))
    return out


def quantize_codes(w: torch.Tensor, w_min: float, bucket: float
                   ) -> torch.Tensor:
    """(n,) f32 -> (n,) int16 holding the uint16 codes (view them as
    ``<u2`` on the host). ``w_min`` / ``bucket`` are rounded to f32."""
    if not w.is_cuda:
        return quantize_codes_ref(w, w_min, bucket)
    _check_flat(w, "w", torch.float32)
    q = torch.empty(w.shape, dtype=torch.int16, device=w.device)
    if w.numel():
        vec = w.data_ptr() % 16 == 0 and q.data_ptr() % 8 == 0
        _build.launch("quantize_codes", w.data_ptr(), q.data_ptr(),
                      float(w_min), float(bucket), w.numel(), int(vec))
    return q


def dequantize_codes(q: torch.Tensor, w_min: float, bucket: float
                     ) -> torch.Tensor:
    """(n,) int16 uint16 codes -> (n,) f32, bit for bit the numpy decode
    ``np.float32(w_min) + q.astype(np.float32) * np.float32(bucket)``."""
    if not q.is_cuda:
        return dequantize_codes_ref(q, w_min, bucket)
    _check_flat(q, "q", torch.int16)
    w = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.numel():
        vec = q.data_ptr() % 8 == 0 and w.data_ptr() % 16 == 0
        _build.launch("dequantize_codes", q.data_ptr(), w.data_ptr(),
                      float(w_min), float(bucket), q.numel(), int(vec))
    return w
