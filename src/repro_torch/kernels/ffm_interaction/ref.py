"""Plain PyTorch versions of the FFM interaction kernels (port of
``repro/kernels/ffm_interaction/ref.py:7-81``)."""
from __future__ import annotations

import torch


def ffm_interaction_matrix_ref(e: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """e: (B, F, F, K); v: (B, F) -> (B, F, F) in e.dtype, computed in f32."""
    ef, vf = e.to(torch.float32), v.to(torch.float32)
    dots = torch.einsum("bijk,bjik->bij", ef, ef)
    return (dots * (vf[:, :, None] * vf[:, None, :])).to(e.dtype)


def ffm_candidate_matrices_ref(ectx, vctx, ecx, ecc, vcand):
    """ectx: (R, Fc, Fcand, K); vctx: (R, Fc); ecx: (R, N, Fcand, Fc, K);
    ecc: (R, N, Fcand, Fcand, K); vcand: (R, N, Fcand)
    -> xc (R, N, Fc, Fcand), aa (R, N, Fcand, Fcand)."""
    dots_xc = torch.einsum("rijk,rnjik->rnij", ectx, ecx)
    xc = dots_xc * vctx[:, None, :, None] * vcand[:, :, None, :]
    dots_aa = torch.einsum("rnijk,rnjik->rnij", ecc, ecc)
    aa = dots_aa * vcand[:, :, :, None] * vcand[:, :, None, :]
    return xc, aa


def ffm_candidate_matrices_q8_ref(ectx, vctx, qcx, qcc, scale, zero, vcand):
    """Dequantize the int8 candidate codes with the per-row ``(scale,
    zero)`` grids, then the f32 math of :func:`ffm_candidate_matrices_ref`."""
    s = scale[..., None, None]
    z = zero[..., None, None]
    ecx = qcx.to(torch.float32) * s + z
    ecc = qcc.to(torch.float32) * s + z
    return ffm_candidate_matrices_ref(ectx, vctx, ecx, ecc, vcand)


def _ctx_tail_ref(ectx, vctx, depth):
    """Full ctx-ctx pair matrix (value products applied) plus per-row tail
    pair sum — pairs (i, j) with i < j and j >= depth[r]."""
    fc = ectx.shape[1]
    ec = ectx[:, :, :fc]
    d = torch.einsum("rijk,rjik->rij", ec, ec)
    d = d * vctx[:, :, None] * vctx[:, None, :]
    ii = torch.arange(fc, device=d.device)[:, None]
    jj = torch.arange(fc, device=d.device)[None, :]
    mask = (ii < jj)[None] & (jj[None] >= depth[:, None, None])
    tail = torch.sum(torch.where(mask, d, 0.0), dim=(1, 2))
    return d, tail


def ffm_fused_logits_rows_ref(ectx, vctx, depth, base, ecx, ecc, vcand):
    """ectx: (R, Fc, F, K); vctx: (R, Fc); depth: (R,) int32; base: (R, N);
    ecx: (R, N, Fcand, Fc, K); ecc: (R, N, Fcand, Fcand, K);
    vcand: (R, N, Fcand) -> (logits (R, N), ctx_dots (R, Fc, Fc))."""
    fc = ectx.shape[1]
    d, tail = _ctx_tail_ref(ectx, vctx, depth)
    ex = ectx[:, :, fc:]                        # (R, Fc, Fcand, K)
    dx = torch.einsum("rijk,rnjik->rnij", ex, ecx)
    xc = dx * vctx[:, None, :, None] * vcand[:, :, None, :]
    da = torch.einsum("rnijk,rnjik->rnij", ecc, ecc)
    fcand = vcand.shape[-1]
    tri = torch.triu(torch.ones((fcand, fcand), dtype=torch.bool,
                                device=da.device), 1)
    aa = torch.where(tri, da * vcand[:, :, :, None] * vcand[:, :, None, :],
                     0.0)
    out = (base + tail[:, None] + torch.sum(xc, dim=(2, 3))
           + torch.sum(aa, dim=(2, 3)))
    return out, d


def ffm_fused_logits_q8_ref(ectx, vctx, depth, base, qcx, qcc, scale, zero,
                            vcand):
    """Dequantize the int8 candidate codes to f32 rows, then the f32 fused
    math of :func:`ffm_fused_logits_rows_ref`. The kernel's int32-exact code
    dots reassociate the same sums, so agreement is within the
    ``quantization.fused_logit_tolerance`` rounding envelope, not bitwise."""
    s = scale[..., None, None]
    z = zero[..., None, None]
    ecx = qcx.to(torch.float32) * s + z
    ecc = qcc.to(torch.float32) * s + z
    return ffm_fused_logits_rows_ref(ectx, vctx, depth, base, ecx, ecc, vcand)
