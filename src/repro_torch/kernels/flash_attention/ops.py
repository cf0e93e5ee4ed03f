"""Flash attention through the kernel (port of
``repro/kernels/flash_attention/ops.py``).

:func:`flash_attention` computes ``softmax(q kᵀ D^-½ + mask) v`` with GQA.
A CPU tensor gets the plain version (``ref.py``); a CUDA tensor gets K11 in
``csrc/flash_attention.cu`` or an exception. Unlike the Pallas wrapper
nothing is padded or transposed and no block size is chosen here: the
kernel reads q, k and v in their (B, S, heads, D) layouts, masks the ragged
tail tiles and fixes its own tiling. K11 has two bodies, picked by dtype
(:data:`BODIES`): bf16 runs on TMA and ``wgmma`` (sm_90a), f32 on CUDA-core
FMAs. v may be narrower than q and k (MLA: qk dim 192, v dim 128), and is
taken at its own width, never padded.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# (qk head dim D, v head dim Dv) pairs each instance takes: D = Dv for the
# GQA families, deepseek-v2's MLA at 192 / 128 (config) and 48 / 32 (smoke)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (112, 112), (128, 128), (48, 32),
             (192, 128))
# the body of csrc/flash_attention.cu that serves each dtype, and the (D, Dv)
# pairs it is instantiated for (the C entry's switch)
BODIES = {torch.bfloat16: ("wgmma", HEAD_DIMS),  # TMA + wgmma
          torch.float32: ("cuda-core", HEAD_DIMS)}  # f32 FMAs
TMA_ALIGN = 16  # bytes: a TMA tensor map's base address


def kernel_body(dtype: torch.dtype, d: int, dv: int) -> str:
    """The K11 body that takes (dtype, qk head dim d, v head dim dv); raise
    if none does."""
    if dtype not in BODIES:
        raise ValueError(f"flash_attention takes {tuple(BODIES)}, got {dtype}")
    body, pairs = BODIES[dtype]
    if (d, dv) not in pairs:
        raise ValueError(f"head dims (qk {d}, v {dv}) not in the {body} "
                         f"body's {pairs} ({dtype})")
    return body


def check_tma_alignment(**ptrs: int) -> None:
    """Raise unless every address (``name=data_ptr()``) is TMA-aligned."""
    for name, ptr in ptrs.items():
        if ptr % TMA_ALIGN:
            raise ValueError(f"{name} at {ptr:#x} is not {TMA_ALIGN}-byte "
                             "aligned, as the wgmma body's TMA loads need")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Sk, Kv, D); v: (B, Sk, Kv, Dv), one dtype
    (f32 or bf16) on one device -> (B, Sq, H, Dv) in q's dtype, f32
    accumulation, the scores scaled by D^-1/2. The causal mask is aligned at
    position 0 (``cols <= rows``); ``window`` > 0 keeps ``cols > rows -
    window``."""
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"q (B, Sq, H, D), k (B, Sk, Kv, D) and v (B, Sk, "
                         f"Kv, Dv) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)} "
                         "(same B and D, H a multiple of Kv)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    body = kernel_body(q.dtype, d, dv)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check(t, name, q.dtype)
    out = q.new_empty((b, sq, h, dv))
    if out.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("k and v hold no positions")
    if body == "wgmma":
        check_tma_alignment(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr())
    _build.launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, sq, sk, h, kv, d, dv, int(causal),
                  window, int(q.dtype == torch.bfloat16),
                  float(np.float32(d ** -0.5)))
    return out
