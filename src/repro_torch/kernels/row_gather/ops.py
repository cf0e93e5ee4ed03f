"""Row gather of the int8 serving tables: the kernel on the card, the plain
version on the CPU (port of ``repro/kernels/row_gather/ops.py:203-227``).

The JAX package picks among ``jnp.take``, its Pallas kernel and a host
packed gather by table size, because XLA-CPU's generic gather slows down
above ~2^17 rows. Here the tables live in device memory and every gather of
a CUDA table runs kernel K1 (``csrc/row_gather.cu``); the host pre-gather
and its cliff calibration come with a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.row_gather.ref import gather_dequant_rows_q8_ref


def gather_dequant_rows_q8(codes: torch.Tensor, scale: torch.Tensor,
                           zero: torch.Tensor, idx: torch.Tensor,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Gather rows ``idx`` of an int8 row-quantized table and dequantize.

    codes: (V, ...) int8; scale/zero: (V,) f32; idx: any-shape int32 row
    indices -> f32 ``idx.shape + codes.shape[1:]``, written into ``out``
    when given (a contiguous f32 tensor of that many elements, e.g. a
    recycled buffer). CPU tensors get the plain version; CUDA tensors get
    kernel K1."""
    shape = tuple(idx.shape) + tuple(codes.shape[1:])
    if out is not None and (out.dtype != torch.float32
                            or not out.is_contiguous()
                            or out.numel() != idx.numel() * codes[0].numel()):
        raise ValueError(f"out must be a contiguous float32 tensor of "
                         f"{shape} elements")
    if not codes.is_cuda:
        rows = gather_dequant_rows_q8_ref(codes, scale, zero, idx)
        if out is None:
            return rows
        return out.view(shape).copy_(rows)
    v = codes.shape[0]
    _build.check(codes, "codes", torch.int8)
    _build.check(scale, "scale", torch.float32, (v,))
    _build.check(zero, "zero", torch.float32, (v,))
    _build.check(idx, "idx", torch.int32)
    rowlen = codes[0].numel() if v else 0
    m = idx.numel()
    # one thread per 8 codes where rows allow (out, fresh from the
    # allocator or a recycled buffer's start, is aligned), else one per code
    if out is None:
        out = torch.empty((m, rowlen), dtype=torch.float32,
                          device=codes.device)
    _build.check(out, "out", torch.float32, contiguous=True)
    vec = (rowlen % 8 == 0 and codes.data_ptr() % 8 == 0
           and out.data_ptr() % 32 == 0)
    if m * rowlen // (8 if vec else 1) >= 2**31:
        raise ValueError(f"{m} rows of {rowlen} codes exceed one launch")
    if out.numel():
        _build.launch("gather_dequant_rows_q8", codes.data_ptr(),
                      scale.data_ptr(), zero.data_ptr(), idx.data_ptr(),
                      out.data_ptr(), m, rowlen, int(vec))
    return out.view(shape)


def gather_dequant_rows(qtable, idx: torch.Tensor) -> torch.Tensor:
    """Gather+dequant from an int8 row-quantized table dict — the funnel
    ``ffm.gather_rows`` calls."""
    return gather_dequant_rows_q8(qtable["codes"], qtable["scale"],
                                  qtable["zero"], idx.to(torch.int32))
