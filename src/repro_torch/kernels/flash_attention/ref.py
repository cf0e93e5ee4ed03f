"""Plain PyTorch versions of the flash-attention kernels (port of
``repro/kernels/flash_attention/ref.py``): scores materialized in f32.

:func:`flash_attention_ref` is K11's; with ``return_lse`` it also returns
each row's log-sum-exp of the masked, scaled scores, in natural-log units,
as K11 writes it for the backward. :func:`flash_attention_bwd_ref` is the
backward of K13 (dQ) and K12 (dK, dV), the port's own kernels: it recomputes
``P = exp(S D^-1/2 - lse)`` from that log-sum-exp, as they do.
:func:`flash_attention_bwd_abs_ref` takes the backward's products on
absolute values, the scale of the bf16 kernels' roundoff. They serve the CPU
and the tests, never a CUDA tensor on the main path.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(sq: int, sk: int, causal: bool, window: int, device):
    """(Sq, Sk) bool: the pairs the mask keeps, the causal mask aligned at
    position 0 (``cols <= rows``), a window keeping ``cols > rows -
    window``."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= cols <= rows
    if window:
        m &= cols > rows - window
    return m


def _scores(q: torch.Tensor, k: torch.Tensor):
    """(B, Kv, G, Sq, Sk) f32 scores scaled by D^-1/2, and the scale."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qh = q.reshape(b, sq, kv, h // kv, d)
    scale = d ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), k.float()) * scale
    return s, scale


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """q: (B, Sq, H, D); k: (B, Sk, Kv, D); v: (B, Sk, Kv, Dv) -> (B, Sq, H,
    Dv) in q's dtype, the scores scaled by D^-1/2; with ``return_lse`` also
    the (B, H, Sq) f32 log-sum-exp of the masked scores (natural log)."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    s, _ = _scores(q, k)
    s = s.masked_fill(~_mask(sq, sk, causal, window, q.device), NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    o = o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def _bwd_terms(q, k, v, o, lse, do, causal: bool, window: int):
    """The backward's intermediates in f32: ``P`` and ``dS`` (B, Kv, G, Sq,
    Sk), dO and q as (B, Sq, Kv, G, ·), and the scale D^-1/2."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    s, scale = _scores(q, k)
    keep = _mask(sq, sk, causal, window, q.device)
    lse5 = lse.float().reshape(b, kv, g, sq)[..., None]
    p = torch.exp(s - lse5).masked_fill(~keep, 0.0)  # (B, Kv, G, Sq, Sk)
    dof = do.float().reshape(b, sq, kv, g, -1)
    of = o.float().reshape(b, sq, kv, g, -1)
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)[..., None]  # (B,Kv,G,Sq,1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    ds = p * (dp - delta)
    qh = q.float().reshape(b, sq, kv, g, d)
    return p, ds, dof, qh, scale


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0):
    """The gradients of :func:`flash_attention_ref` at (q, k, v) for the
    output cotangent ``do`` (B, Sq, H, Dv), from the forward's output ``o``
    and log-sum-exp ``lse`` (B, H, Sq, natural log). f32 arithmetic:

    ``P = exp(S D^-1/2 - lse)`` (0 where masked), ``Δ = rowsum(dO ∘ O)``,
    ``dV = Pᵀ dO``, ``dS = P ∘ (dO Vᵀ - Δ)``, ``dQ = dS K D^-1/2``,
    ``dK = dSᵀ Q D^-1/2``, dK and dV summed over the G query heads of each
    kv head. Returns ``(dq, dk, dv)`` in the inputs' dtype. A row that the
    mask leaves wholly empty gets no gradient (no caller makes one)."""
    b, sq, h, d = q.shape
    p, ds, dof, qh, scale = _bwd_terms(q, k, v, o, lse, do, causal, window)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qh) * scale
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_abs_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, o: torch.Tensor,
                                lse: torch.Tensor, do: torch.Tensor, *,
                                causal: bool = True, window: int = 0):
    """The products of :func:`flash_attention_bwd_ref` on absolute values,
    in f32: ``A_dq = |dS| |K| D^-1/2``, ``A_dk = |dS|ᵀ |Q| D^-1/2``, ``A_dv
    = Pᵀ |dO|`` (P >= 0), A_dk and A_dv summed over the G query heads as
    their gradients are. They scale the roundoff of a bf16 backward that
    rounds P and dS to bf16 before its products: rounding each term of a
    sum by at most 2u moves the sum by at most 2u A (chip_smoke.py's bound
    on K13 / K12). Returns ``(a_dq, a_dk, a_dv)``, shaped as the
    gradients."""
    b, sq, h, d = q.shape
    p, ds, dof, qh, scale = _bwd_terms(q, k, v, o, lse, do, causal, window)
    ads = ds.abs()
    a_dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof.abs())
    a_dq = torch.einsum("bkgqs,bskd->bqkgd", ads, k.float().abs()) * scale
    a_dk = torch.einsum("bkgqs,bqkgd->bskd", ads, qh.abs()) * scale
    return a_dq.reshape(b, sq, h, d), a_dk, a_dv
