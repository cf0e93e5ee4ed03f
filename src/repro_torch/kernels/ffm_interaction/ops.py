"""FFM interactions through the kernels (port of
``repro/kernels/ffm_interaction/ops.py`` and the five Pallas entry points of
``ffm_interaction.py`` it calls).

* :func:`ffm_interaction_matrix`, :func:`ffm_candidate_matrices`,
  :func:`ffm_candidate_matrices_q8`, :func:`ffm_fused_logits_q8` and
  :func:`ffm_fused_logits_rows` keep the Pallas functions' layouts. A CPU
  tensor gets the plain version (``ref.py``); a CUDA tensor gets kernel K4,
  K2, K3 (``csrc/ffm_interaction.cu``), K5 or K6
  (``csrc/ffm_fused_logits.cu``) or an exception. The kernels mask the
  ragged candidate tile themselves, so nothing is padded.
* :func:`interactions`, :func:`candidate_interactions`,
  :func:`candidate_interactions_q8`, :func:`fused_candidate_logits_q8` and
  :func:`fused_candidate_logits_rows` keep the JAX ops' signatures: the
  first is a drop-in ``interactions_fn`` for ``deepffm.forward``, the next
  two compute the candidate-dependent pair columns from cached context
  partials, the last two the fused path's logits and ctx pair matrices.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ffm as ffm_core
from repro_torch.kernels import _build
from repro_torch.kernels.ffm_interaction.ref import (
    ffm_candidate_matrices_q8_ref, ffm_candidate_matrices_ref,
    ffm_fused_logits_q8_ref, ffm_fused_logits_rows_ref,
    ffm_interaction_matrix_ref)

_SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90


# -- the kernels' work: operations and bytes of the function, every input
# read once and every output written once (the bounds of chip_smoke.py) --

def k4_work(b: int, f: int, k: int, esz: int = 4):
    """K4: the (B, F, F) dot matrix, 2K + 2 operations an entry (the dot
    and the two value products); e, v read and D written in e's dtype."""
    return b * f * f * (2 * k + 2), b * (f * f * k + f + f * f) * esz


def _candidate_work(r, n, fc, fcand, k, q8: bool):
    rnc = r * n * fcand
    outs = r * n * (fc * fcand + fcand * fcand)
    ctx = r * (fc * fcand * k + fc) * 4 + rnc * 4  # ectx, vctx, vcand
    f = fc + fcand
    if q8:  # codes and two f32 grid scalars a row; a dequant multiply-add
        return outs * (2 * k + 2) + rnc * f * k * 2, \
            ctx + rnc * (f * k + 8) + outs * 4
    return outs * (2 * k + 2), ctx + rnc * f * k * 4 + outs * 4


def k2_work(r: int, n: int, fc: int, fcand: int, k: int):
    """K2: the (R, N, Fc, Fcand) and (R, N, Fcand, Fcand) f32 dot matrices
    of R rows of N candidates, 2K + 2 operations an entry."""
    return _candidate_work(r, n, fc, fcand, k, False)


def k3_work(r: int, n: int, fc: int, fcand: int, k: int):
    """K3: K2's function over int8 candidate codes, dequantized in
    registers (one multiply-add a code)."""
    return _candidate_work(r, n, fc, fcand, k, True)


def _fused_work(r, n, fc, fcand, k, q8: bool):
    f = fc + fcand
    rnc = r * n * fcand
    n_aa = fcand * (fcand - 1) // 2
    # ectx, vctx, depth, ctx_dots; base in and logits out; vcand
    io = (r * (fc * f * k + fc + 1 + fc * fc) * 4 + r * n * 2 * 4
          + rnc * 4)
    # the ctx pair matrix once a row; per candidate the ctx x cand and the
    # ic < jc cand x cand terms (int8 dot and code-sum ops counted as f32
    # operations, so the bound is if anything high)
    per_cand = (fc * fcand * (2 * k + 3 + (k + 3 if q8 else 0))
                + n_aa * (2 * k + 3 + (4 * k + 10 if q8 else 0)) + 3)
    flops = r * fc * fc * (2 * k + 3) + r * n * per_cand
    return flops, io + rnc * (f * k + 8 if q8 else f * k * 4)


def k5_work(r: int, n: int, fc: int, fcand: int, k: int):
    """K5: one fused bucket over int8 candidate codes and their grids."""
    return _fused_work(r, n, fc, fcand, k, True)


def k6_work(r: int, n: int, fc: int, fcand: int, k: int):
    """K6: one fused bucket over f32 candidate rows."""
    return _fused_work(r, n, fc, fcand, k, False)


def ffm_interaction_matrix(e: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """e: (B, F, F, K) f32 or bf16 gathered embeddings; v: (B, F) ->
    (B, F, F) dot matrix in e.dtype (f32 accumulation)."""
    with _build.booking("ffm_interaction_matrix", lambda: k4_work(
            e.shape[0], e.shape[1], e.shape[-1], e.element_size())):
        return _interaction_call(e, v)


def _interaction_call(e, v):
    if not e.is_cuda:
        return ffm_interaction_matrix_ref(e, v)
    if e.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"e must be float32 or bfloat16, got {e.dtype}")
    b, f, f2, k = e.shape
    if f2 != f:
        raise ValueError(f"e must be (B, F, F, K), got {tuple(e.shape)}")
    _build.check(e, "e", e.dtype)
    _build.check(v, "v", e.dtype, (b, f))
    if b * f * f >= 2**31:  # one thread per output
        raise ValueError(f"(B, F) = {(b, f)} exceeds one launch")
    out = torch.empty((b, f, f), dtype=e.dtype, device=e.device)
    if out.numel():
        _build.launch("ffm_interaction_matrix", e.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, f, k, int(e.dtype == torch.bfloat16))
    return out


def _candidate_dims(ectx, ecx):
    """(R, N, Fc, Fcand, K) of a K2 / K3 call."""
    r, fc, fcand, k = ectx.shape
    return r, ecx.shape[1], fc, fcand, k


def _fused_dims(ectx, vcand):
    """(R, N, Fc, Fcand, K) of a K5 / K6 call."""
    r, fc, f, k = ectx.shape
    return r, vcand.shape[1], fc, f - fc, k


def _check_k_contiguous(k, **blocks):
    for nm, t in blocks.items():
        if k > 1 and t.stride(-1) != 1:
            raise ValueError(f"{nm} must be contiguous along K")


def _vec8(k, cand_strides, ecx, ecc, q8):
    """Whether the kernels may load K=8 candidate rows as two float4 (f32)
    or one 8-byte word (int8): every row start must be aligned to 16 bytes
    (f32) or 8 bytes (int8)."""
    align = 8 if q8 else 16
    return (k == 8 and all(s % 8 == 0 for s in cand_strides)
            and ecx.data_ptr() % align == 0 and ecc.data_ptr() % align == 0)


def _candidate_launch(name, ectx, vctx, ecx, ecc, grids, vcand):
    """Shared checks and launch of K2 (``grids`` None) and K3."""
    r, fc, fcand, k = ectx.shape
    n = ecx.shape[1]
    cand_dtype = torch.int8 if grids is not None else torch.float32
    _build.check(ectx, "ectx", torch.float32, contiguous=False)
    _build.check(vctx, "vctx", torch.float32, (r, fc))
    _build.check(ecx, "ecx", cand_dtype, (r, n, fcand, fc, k), contiguous=False)
    _build.check(ecc, "ecc", cand_dtype, (r, n, fcand, fcand, k),
                 contiguous=False)
    _build.check(vcand, "vcand", torch.float32, (r, n, fcand))
    _check_k_contiguous(k, ectx=ectx, ecx=ecx, ecc=ecc)
    if (fc * fcand * k + fc) * 4 > _SMEM_MAX:
        raise ValueError(f"(Fc, Fcand, K) = {(fc, fcand, k)} exceeds "
                         "shared memory")
    xc = torch.empty((r, n, fc, fcand), dtype=torch.float32,
                     device=ectx.device)
    aa = torch.empty((r, n, fcand, fcand), dtype=torch.float32,
                     device=ectx.device)
    if r == 0 or n == 0:
        return xc, aa
    strides = ectx.stride()[:3] + ecx.stride()[:4] + ecc.stride()[:4]
    vec8 = _vec8(k, strides[3:], ecx, ecc, grids is not None)
    c_strides = (ctypes.c_int64 * len(strides))(*strides)
    grid_ptrs = ()
    if grids is not None:
        scale, zero = grids
        _build.check(scale, "scale", torch.float32, (r, n, fcand))
        _build.check(zero, "zero", torch.float32, (r, n, fcand))
        grid_ptrs = (scale.data_ptr(), zero.data_ptr())
    _build.launch(name, ectx.data_ptr(), vctx.data_ptr(), ecx.data_ptr(),
                  ecc.data_ptr(), vcand.data_ptr(), *grid_ptrs, xc.data_ptr(),
                  aa.data_ptr(), ctypes.addressof(c_strides), r, n, fc, fcand,
                  k, int(vec8))
    return xc, aa


def ffm_candidate_matrices(ectx, vctx, ecx, ecc, vcand):
    """Candidate-block interactions consuming cached context partials (§5).

    ectx:  (R, Fc, Fcand, K)    cached context embeddings for candidate fields
    vctx:  (R, Fc)              cached context values
    ecx:   (R, N, Fcand, Fc, K) candidate embeddings for context fields
    ecc:   (R, N, Fcand, Fcand, K) candidate embeddings for candidate fields
    vcand: (R, N, Fcand)        candidate values
    ->     xc (R, N, Fc, Fcand), aa (R, N, Fcand, Fcand) f32 dot matrices
    """
    with _build.booking("ffm_candidate_matrices",
                        lambda: k2_work(*_candidate_dims(ectx, ecx))):
        if not ectx.is_cuda:
            return ffm_candidate_matrices_ref(ectx, vctx, ecx, ecc, vcand)
        return _candidate_launch("ffm_candidate_matrices", ectx, vctx, ecx,
                                 ecc, None, vcand)


def ffm_candidate_matrices_q8(ectx, vctx, qcx, qcc, scale, zero, vcand):
    """Dequantize-in-registers twin of :func:`ffm_candidate_matrices`: the
    candidate rows arrive as int8 codes ``qcx`` (R, N, Fcand, Fc, K) and
    ``qcc`` (R, N, Fcand, Fcand, K) with one ``(scale, zero)`` f32 pair per
    candidate row (R, N, Fcand); the f32 candidate block never exists in
    device memory."""
    with _build.booking("ffm_candidate_matrices_q8",
                        lambda: k3_work(*_candidate_dims(ectx, qcx))):
        if not ectx.is_cuda:
            return ffm_candidate_matrices_q8_ref(ectx, vctx, qcx, qcc, scale,
                                                 zero, vcand)
        return _candidate_launch("ffm_candidate_matrices_q8", ectx, vctx,
                                 qcx, qcc, (scale, zero), vcand)


def _fused_launch(name, ectx, vctx, depth, base, ecx, ecc, grids, vcand):
    """Shared checks and launch of K6 (``grids`` None) and K5."""
    if ectx.dim() != 4:
        raise ValueError(f"ectx must be (R, Fc, F, K), got {tuple(ectx.shape)}")
    r, fc, f, k = ectx.shape
    fcand = f - fc
    if fcand < 1:
        raise ValueError(f"ectx (R, Fc, F, K) needs F > Fc, got {(fc, f)}")
    n = vcand.shape[1] if vcand.dim() == 3 else -1
    cand_dtype = torch.int8 if grids is not None else torch.float32
    _build.check(ectx, "ectx", torch.float32, contiguous=False)
    _build.check(vctx, "vctx", torch.float32, (r, fc))
    _build.check(depth, "depth", torch.int32, (r,))
    _build.check(base, "base", torch.float32, (r, n))
    _build.check(ecx, "ecx", cand_dtype, (r, n, fcand, fc, k), contiguous=False)
    _build.check(ecc, "ecc", cand_dtype, (r, n, fcand, fcand, k),
                 contiguous=False)
    _build.check(vcand, "vcand", torch.float32, (r, n, fcand))
    _check_k_contiguous(k, ectx=ectx, ecx=ecx, ecc=ecc)
    if r > 65535:
        raise ValueError(f"R = {r} rows exceeds the grid's y extent")
    logits = torch.empty((r, n), dtype=torch.float32, device=ectx.device)
    dots = torch.empty((r, fc, fc), dtype=torch.float32, device=ectx.device)
    if r == 0:
        return logits, dots
    strides = ectx.stride()[:3] + ecx.stride()[:4] + ecc.stride()[:4]
    # K5/K6 load the context rows as two float4 too: 16-byte aligned
    vec8 = (_vec8(k, strides[3:], ecx, ecc, grids is not None)
            and all(s % 4 == 0 for s in strides[:3])
            and ectx.data_ptr() % 16 == 0)
    c_strides = (ctypes.c_int64 * len(strides))(*strides)
    grid_ptrs = ()
    if grids is not None:
        scale, zero = grids
        _build.check(scale, "scale", torch.float32, (r, n, fcand))
        _build.check(zero, "zero", torch.float32, (r, n, fcand))
        grid_ptrs = (scale.data_ptr(), zero.data_ptr())
    # a row without candidates still gets its ctx_dots (one tile per row)
    _build.launch(name, ectx.data_ptr(), vctx.data_ptr(), depth.data_ptr(),
                  base.data_ptr(), ecx.data_ptr(), ecc.data_ptr(), *grid_ptrs,
                  vcand.data_ptr(), logits.data_ptr(), dots.data_ptr(),
                  ctypes.addressof(c_strides), r, n, fc, fcand, k, int(vec8))
    return logits, dots


def ffm_fused_logits_q8(ectx, vctx, depth, base, qcx, qcc, scale, zero,
                        vcand):
    """One fused call per padding bucket: context-tail pairs + int8
    candidate pair terms + the additive FFM head.

    ectx:  (R, Fc, F, K) f32   full-depth context embeddings
    vctx:  (R, Fc)             context values
    depth: (R,) int32          cached prefix depth p per row: pairs with
                               j >= p are computed here, the rest arrive
                               pre-summed inside ``base``
    base:  (R, N) f32          lr_ctx + lr_cand + bias + cached ctx pair sum
    qcx:   (R, N, Fcand, Fc, K) int8    candidate codes, ctx-field columns
    qcc:   (R, N, Fcand, Fcand, K) int8 candidate codes, cand-field columns
    scale/zero: (R, N, Fcand) f32       per-candidate-row grids
    vcand: (R, N, Fcand)
    ->     logits (R, N) f32, ctx_dots (R, Fc, Fc) f32 (the ctx pair matrix
           with value products applied, from which the engine rebuilds
           insertable prefix states)
    """
    with _build.booking("ffm_fused_logits_q8",
                        lambda: k5_work(*_fused_dims(ectx, vcand))):
        if not ectx.is_cuda:
            return ffm_fused_logits_q8_ref(ectx, vctx, depth, base, qcx, qcc,
                                           scale, zero, vcand)
        return _fused_launch("ffm_fused_logits_q8", ectx, vctx, depth, base,
                             qcx, qcc, (scale, zero), vcand)


def ffm_fused_logits_rows(ectx, vctx, depth, base, ecx, ecc, vcand):
    """f32 twin of :func:`ffm_fused_logits_q8`: gathered f32 candidate rows
    ``ecx`` (R, N, Fcand, Fc, K) / ``ecc`` (R, N, Fcand, Fcand, K) instead
    of codes and grids. Returns (logits (R, N), ctx_dots (R, Fc, Fc))."""
    with _build.booking("ffm_fused_logits_rows",
                        lambda: k6_work(*_fused_dims(ectx, vcand))):
        if not ectx.is_cuda:
            return ffm_fused_logits_rows_ref(ectx, vctx, depth, base, ecx,
                                             ecc, vcand)
        return _fused_launch("ffm_fused_logits_rows", ectx, vctx, depth,
                             base, ecx, ecc, None, vcand)


def interactions(cfg, emb, idx, val):
    """(B, n_pairs) DiagMask'd interactions from the kernel's dot matrix.
    ``emb`` may be an int8 row-quantized table dict (``ffm.gather_rows``)."""
    e = ffm_core.gather_rows(emb, idx)  # (B, F, F, K)
    d = ffm_interaction_matrix(e, val)
    pi, pj = ffm_core.on_device(ffm_core.pair_indices, (cfg.n_fields,),
                                d.device)
    return d[:, pi, pj]


def _pair_columns(cfg, xc_mat, aa_mat):
    fc = cfg.context_fields
    (pi, pj), _, xc, aa = ffm_core.on_device(ffm_core.pair_split, (cfg,),
                                             xc_mat.device)
    pairs_xc = xc_mat[:, :, pi[xc], pj[xc] - fc]
    pairs_aa = aa_mat[:, :, pi[aa] - fc, pj[aa] - fc]
    return pairs_xc, pairs_aa


def candidate_interactions(cfg, emb_ctx, val_ctx, ec, cand_val):
    """Candidate-block pair columns from cached context partials.

    emb_ctx: (R, Fc, F, K) cached context embeddings; val_ctx: (R, Fc);
    ec: (R, N, Fcand, F, K) candidate embeddings; cand_val: (R, N, Fcand)
    -> (pairs_xc (R, N, n_xc), pairs_aa (R, N, n_aa)) in the positions given
    by ``ffm.pair_split(cfg)``.
    """
    fc = cfg.context_fields
    xc_mat, aa_mat = ffm_candidate_matrices(
        emb_ctx[:, :, fc:], val_ctx, ec[..., :fc, :], ec[..., fc:, :],
        cand_val)
    return _pair_columns(cfg, xc_mat, aa_mat)


def candidate_interactions_q8(cfg, emb_ctx, val_ctx, qc, scale, zero,
                              cand_val):
    """Quantized-serving twin of :func:`candidate_interactions`: ``qc`` is
    the int8 code block ``(R, N, Fcand, F, K)`` gathered from the
    row-quantized table, ``scale``/``zero`` ``(R, N, Fcand)`` its grids."""
    fc = cfg.context_fields
    xc_mat, aa_mat = ffm_candidate_matrices_q8(
        emb_ctx[:, :, fc:], val_ctx, qc[..., :fc, :], qc[..., fc:, :],
        scale, zero, cand_val)
    return _pair_columns(cfg, xc_mat, aa_mat)


def fused_candidate_logits_q8(cfg, emb_ctx, val_ctx, depth, base, qc, scale,
                              zero, cand_val):
    """Fused scoring of one padding bucket over gathered int8 codes ``qc``
    ``(R, N, Fcand, F, K)``, split here into its context-field and
    candidate-field column halves (views, not copies) with ``scale``/``zero``
    ``(R, N, Fcand)`` its grids. ``depth``/``base`` carry the cached-prefix
    split. Returns ``(logits (R, N), ctx_dots (R, Fc, Fc))``."""
    fc = cfg.context_fields
    return ffm_fused_logits_q8(
        emb_ctx, val_ctx, depth.to(torch.int32), base,
        qc[..., :fc, :], qc[..., fc:, :], scale, zero, cand_val)


def fused_candidate_logits_rows(cfg, emb_ctx, val_ctx, depth, base, ec,
                                cand_val):
    """f32 twin of :func:`fused_candidate_logits_q8` (gathered f32 rows
    ``ec`` ``(R, N, Fcand, F, K)``)."""
    fc = cfg.context_fields
    return ffm_fused_logits_rows(
        emb_ctx, val_ctx, depth.to(torch.int32), base,
        ec[..., :fc, :], ec[..., fc:, :], cand_val)
