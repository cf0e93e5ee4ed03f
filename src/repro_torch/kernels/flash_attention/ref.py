"""Plain PyTorch version of the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py``): scores materialized in f32."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Sk, Kv, D); v: (B, Sk, Kv, Dv) -> (B, Sq, H,
    Dv) in q's dtype, the scores scaled by D^-1/2."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qh = q.reshape(b, sq, kv, h // kv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), k.float()) * (d ** -0.5)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= cols <= rows
    if window:
        m &= cols > rows - window
    s = s.masked_fill(~m, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
