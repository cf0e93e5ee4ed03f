"""Int8 serving format (port of ``repro/core/quantization.py:186-500``).

Codes and grids are computed on the host in numpy, exactly as in the JAX
package, so both packages hold bit-identical tables; the quantized tensors
then move to the device the params live on. The 16-bit wire format comes
with the weight-transfer slice.

Grid: symmetric-around-midpoint affine. For row r with values in
[mn, mx]: scale_r = (mx - mn) / (ROW_LEVELS - 1), zero_r = (mn + mx) / 2,
code = round((w - zero_r) / scale_r) in [-127, 127] (int8; -128 unused so
the grid is symmetric). Dequantize: w ≈ code * scale_r + zero_r.
Reconstruction error is bounded by scale_r / 2 per element
(:func:`row_max_error`), which :func:`pair_logit_tolerance` lifts to a
rigorous bound on the FFM interaction logits.
"""
from __future__ import annotations

import numpy as np
import torch

ROW_LEVELS = 255  # codes -127..127
LR_BLOCK = 64


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def quantize_rows(w: np.ndarray):
    """Row-wise int8 quantization of a table ``w`` (rows on axis 0).
    Returns ``{"codes": int8 w.shape, "scale": f32 (rows,), "zero": f32
    (rows,)}`` as numpy arrays."""
    w = np.asarray(w, np.float32)
    flat = w.reshape(w.shape[0], -1)
    mn = flat.min(axis=1)
    mx = flat.max(axis=1)
    # degenerate (constant) rows: scale 1 and codes 0 reconstruct mn exactly
    scale = np.where(mx > mn, (mx - mn) / np.float32(ROW_LEVELS - 1),
                     np.float32(1.0)).astype(np.float32)
    zero = ((mn + mx) * np.float32(0.5)).astype(np.float32)
    bshape = (w.shape[0],) + (1,) * (w.ndim - 1)
    q = np.rint((w - zero.reshape(bshape)) / scale.reshape(bshape))
    codes = np.clip(q, -127, 127).astype(np.int8)
    return {"codes": codes, "scale": scale, "zero": zero}


def dequantize_rows(qtable) -> np.ndarray:
    """Full-table f32 reconstruction (oracle/debug; the request path
    dequantizes gathered rows instead)."""
    codes = _np(qtable["codes"])
    bshape = (codes.shape[0],) + (1,) * (codes.ndim - 1)
    return (codes.astype(np.float32) * _np(qtable["scale"]).reshape(bshape)
            + _np(qtable["zero"]).reshape(bshape))


def is_row_quantized(leaf) -> bool:
    """True for the quantized-table dict :func:`quantize_rows` produces
    (excluding the blocked variant — see :func:`is_block_quantized`)."""
    return (isinstance(leaf, dict) and "codes" in leaf and "scale" in leaf
            and "block" not in leaf)


def quantize_blocks(w: np.ndarray, block: int = LR_BLOCK) -> dict:
    """Blocked int8 quantization of a flat ``(V,)`` float vector. Returns
    ``{"codes": int8 (V,), "scale": f32 (ceil(V/B),), "zero": f32
    (ceil(V/B),), "block": B}``. A trailing partial block is padded with its
    own last element (does not perturb the block's min/max)."""
    w = np.asarray(w, np.float32).reshape(-1)
    v = w.size
    nb = -(-v // block)
    wp = w if nb * block == v else np.concatenate(
        [w, np.full(nb * block - v, w[-1], np.float32)])
    wb = wp.reshape(nb, block)
    mn = wb.min(axis=1)
    mx = wb.max(axis=1)
    scale = np.where(mx > mn, (mx - mn) / np.float32(ROW_LEVELS - 1),
                     np.float32(1.0)).astype(np.float32)
    zero = ((mn + mx) * np.float32(0.5)).astype(np.float32)
    q = np.rint((wb - zero[:, None]) / scale[:, None])
    codes = np.clip(q, -127, 127).astype(np.int8).reshape(-1)[:v]
    return {"codes": codes, "scale": scale, "zero": zero, "block": int(block)}


def dequantize_blocks(qtable: dict) -> np.ndarray:
    """Full-vector f32 reconstruction (oracle/debug)."""
    codes = _np(qtable["codes"])
    block = int(qtable["block"])
    b = np.arange(codes.size) // block
    return (codes.astype(np.float32) * _np(qtable["scale"])[b]
            + _np(qtable["zero"])[b])


def is_block_quantized(leaf) -> bool:
    """True for the blocked-table dict :func:`quantize_blocks` produces."""
    return isinstance(leaf, dict) and "codes" in leaf and "block" in leaf


def block_max_error(qtable) -> float:
    """Max |w - dequantize(quantize(w))| over the vector: half the coarsest
    block's bucket."""
    return float(np.max(_np(qtable["scale"]))) * 0.5


def row_max_error(qtable) -> float:
    """Max |w - dequantize(quantize(w))| over the table: half the coarsest
    row's bucket."""
    return float(np.max(_np(qtable["scale"]))) * 0.5


def pair_logit_tolerance(cfg, emb_absmax: float, eps: float,
                         vmax: float = 1.0, lr_eps: float = 0.0) -> float:
    """Rigorous bound on the FFM-logit deviation caused by per-element
    embedding error ``eps`` (= :func:`row_max_error` of the serving table)
    plus per-weight LR error ``lr_eps`` (= :func:`block_max_error` of the
    blocked LR table; 0 when the LR table is served f32). Each DiagMask pair
    deviates by at most ``k * (2 * |e|_inf * eps + eps^2) * vmax^2``; the
    ``ffm`` head sums ``n_pairs`` of them plus ``n_fields`` LR terms."""
    per_pair = cfg.k * (2.0 * emb_absmax * eps + eps * eps) * vmax * vmax
    return cfg.n_pairs * per_pair + cfg.n_fields * lr_eps * vmax


def fused_logit_tolerance(cfg, emb_absmax: float, eps: float,
                          vmax: float = 1.0, lr_max: float = 1.0) -> float:
    """Float-reassociation envelope between the fused logit kernels and the
    staged (dequantize-rows-then-f32-dots) path on the *same* tables:
    quantization error cancels and only f32 rounding from reordered sums
    remains. Each pair dot is bounded by ``k * amax^2`` (``amax =
    emb_absmax + eps``, the dequantized-row bound) and charged one ulp
    (``u = 2^-24``) per floating operation along the deepest reassociated
    chain — ``2k`` for the dot, ~``8`` for the affine recombination,
    ``n_pairs`` for the head-sum reorder; the LR/base terms reorder across
    at most ``n_fields + 2`` adds of magnitude ``<= lr_max * vmax``. A
    worst-case chain bound, deliberately generous, not an expected error."""
    u = 2.0 ** -24
    amax = emb_absmax + eps
    per_pair = cfg.k * amax * amax * vmax * vmax
    pair_part = cfg.n_pairs * per_pair * (2.0 * cfg.k + 8.0 + cfg.n_pairs) * u
    lr_part = cfg.n_fields * lr_max * vmax * (cfg.n_fields + 2.0) * u
    return pair_part + lr_part


ROW_QUANT_PATHS = (("ffm", "emb"), ("emb",))
BLOCK_QUANT_PATHS = (("lr", "w"),)


def _walk(tree, path):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node


def _to_tensors(table: dict, device: torch.device) -> dict:
    return {k: (v if isinstance(v, int) else torch.from_numpy(v).to(device))
            for k, v in table.items()}


def quantize_params_rows(params, paths=ROW_QUANT_PATHS,
                         block_paths=BLOCK_QUANT_PATHS,
                         lr_block: int = LR_BLOCK):
    """Replace the gather-table leaves of a params tree with int8 tables on
    the leaf's device: per-row grids for ``paths`` (the embedding tables),
    blocked grids for ``block_paths`` (the LR vector). Every other leaf
    stays as it is. Leaves that are already quantized are kept. Returns a
    new top-level tree; untouched subtrees are shared."""
    out = dict(params)
    for path, blocked in ([(p, False) for p in paths]
                          + [(p, True) for p in block_paths]):
        node = _walk(out, path)
        if node is None or isinstance(node, dict):
            continue
        # copy the subdict chain so the caller's tree is never mutated
        sub = out
        for key in path[:-1]:
            sub[key] = dict(sub[key])
            sub = sub[key]
        host = _np(node)
        table = (quantize_blocks(host, lr_block) if blocked
                 else quantize_rows(host))
        sub[path[-1]] = _to_tensors(table, node.device)
    return out
