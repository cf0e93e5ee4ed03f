"""Plain PyTorch versions of the FFM interaction kernels (port of
``repro/kernels/ffm_interaction/ref.py:7-35``)."""
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
