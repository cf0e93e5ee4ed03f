"""Quantization (port of ``repro/core/quantization.py``): the paper's 16-bit
wire format (§6) and the int8 serving format.

**Wire format.** One global dynamic-range grid over the whole weight space,
optimized for byte-stable diffs across updates: a first pass takes the
min/max (kernel K7 on the card), the bounds are rounded to ``beta`` /
``alpha`` decimals on the host exactly as in the JAX package (Python
floats, :func:`_floor_dec` / :func:`_ceil_dec`), and a second pass maps
each weight to ``round((w - w_min) / bucket)`` as uint16 (kernel K8).
:func:`quantize` with ``prev`` keeps the previous grid (hysteresis) and
ships weights outside it in an outlier sidecar. Codes live in int16
tensors holding the uint16 bit patterns; :func:`to_bytes` writes them as
``<u2``. The receiver's decode :func:`dequantize_from_bytes` is numpy; on
the card :func:`dequantize` (kernel K9) equals it bit for bit.

**Int8 serving format.** Codes and grids are computed on the host in numpy,
exactly as in the JAX package, so both packages hold bit-identical tables;
the quantized tensors then live on the device the params live on.

Grid: symmetric-around-midpoint affine. For row r with values in
[mn, mx]: scale_r = (mx - mn) / (ROW_LEVELS - 1), zero_r = (mn + mx) / 2,
code = round((w - zero_r) / scale_r) in [-127, 127] (int8; -128 unused so
the grid is symmetric). Dequantize: w ≈ code * scale_r + zero_r.
Reconstruction error is bounded by scale_r / 2 per element
(:func:`row_max_error`), which :func:`pair_logit_tolerance` lifts to a
rigorous bound on the FFM interaction logits.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.quantize import ops as qops

HEADER_FMT = "<ffQQ"  # (w_min: f32, bucket_size: f32, n: u64, n_outliers: u64)
HEADER_SIZE = struct.calcsize(HEADER_FMT)
B_MAX = 2**16


@dataclass(frozen=True)
class QuantMeta:
    w_min: float
    bucket_size: float
    n: int
    n_outliers: int = 0


def _floor_dec(x: float, decimals: int) -> float:
    s = 10.0 ** decimals
    return float(np.floor(x * s) / s)


def _ceil_dec(x: float, decimals: int) -> float:
    s = 10.0 ** decimals
    return float(np.ceil(x * s) / s)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flat_f32(w: torch.Tensor) -> torch.Tensor:
    return w.reshape(-1).to(torch.float32).contiguous()


def _minmax(flat: torch.Tensor) -> Tuple[float, float]:
    """Exact (min, max) of a flat f32 tensor as Python floats (K7 on the
    card; one copy of two floats to the host)."""
    mn, mx = qops.minmax(flat).tolist()
    return mn, mx


def _rounded_bounds(mn: float, mx: float, alpha: int, beta: int
                    ) -> Tuple[float, float]:
    w_min = _floor_dec(mn, beta)
    w_max = _ceil_dec(mx, alpha)
    if w_max <= w_min:  # degenerate (constant weights)
        w_max = w_min + 10.0 ** (-alpha)
    return w_min, w_max


def compute_bounds(w: torch.Tensor, alpha: int = 2, beta: int = 2
                   ) -> Tuple[float, float, float]:
    """First pass: (rounded) min/max and the bucket size. Bounds round
    *conservatively* (floor the min, ceil the max) so no weight is ever
    clipped; the bucket divides by ``B_MAX - 1`` so ``w_max`` maps exactly
    to the top code."""
    w_min, w_max = _rounded_bounds(*_minmax(_flat_f32(w)), alpha, beta)
    return w_min, w_max, (w_max - w_min) / (B_MAX - 1)


def stable_bounds(w: torch.Tensor, prev: Optional["QuantMeta"], alpha: int = 2,
                  beta: int = 2, shrink_limit: float = 4.0
                  ) -> Tuple[float, float]:
    """Grid hysteresis: reuse the previous update's grid verbatim unless the
    new weights fall outside it or the occupied range shrank by more than
    ``shrink_limit``; else re-derive rounded bounds."""
    w_min_raw, w_max_raw = _minmax(_flat_f32(w))
    if prev is not None:
        lo = prev.w_min
        hi = prev.w_min + prev.bucket_size * (B_MAX - 1)
        covers = lo <= w_min_raw and w_max_raw <= hi
        occupied = max(w_max_raw - w_min_raw, 1e-12)
        not_shrunk = (hi - lo) / occupied <= shrink_limit
        if covers and not_shrunk:
            return lo, hi
    return _rounded_bounds(w_min_raw, w_max_raw, alpha, beta)


OUTLIER_REGRID_FRAC = 1e-3


def quantize(w: torch.Tensor, alpha: int = 2, beta: int = 2,
             prev: Optional[QuantMeta] = None):
    """Both passes: uint16 codes (an int16 tensor on ``w``'s device) +
    header metadata + the outlier sidecar ``(idx u64, val f32)`` (numpy;
    empty without hysteresis).

    With ``prev`` (the previous update's meta) the previous grid is kept
    unless more than ``OUTLIER_REGRID_FRAC`` of the weights fall outside it
    or the occupied range shrank more than 4x; weights outside it ride the
    sidecar exactly. The outlier test compares the f32 weights with the f32
    roundings of the Python-float bounds, as numpy does in the JAX package;
    the occupied range is the float64 difference of the exact f32
    extremes (K7)."""
    flat = _flat_f32(w)
    n = int(flat.numel())
    mn, mx = _minmax(flat)
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.float32))
    if prev is not None:
        lo = prev.w_min
        hi = prev.w_min + prev.bucket_size * (B_MAX - 1)
        occupied = max(mx - mn, 1e-12)
        not_shrunk = (hi - lo) / occupied <= 4.0
        f32 = dict(dtype=torch.float32, device=flat.device)
        out_mask = (flat < torch.tensor(lo, **f32)) | (flat > torch.tensor(hi, **f32))
        n_out = int(torch.count_nonzero(out_mask))
        if not_shrunk and n_out / n <= OUTLIER_REGRID_FRAC:
            bucket = prev.bucket_size
            q = qops.quantize_codes(flat, lo, bucket)
            if n_out == 0:
                return q, QuantMeta(lo, bucket, n, 0), empty
            idx = torch.nonzero(out_mask).reshape(-1)
            outliers = (_np(idx).astype(np.uint64), _np(flat[idx]))
            return q, QuantMeta(lo, bucket, n, n_out), outliers
        # too many outliers / shrunk range: dynamic regrid (paper behaviour)
    w_min, w_max = _rounded_bounds(mn, mx, alpha, beta)
    bucket = (w_max - w_min) / (B_MAX - 1)
    q = qops.quantize_codes(flat, w_min, bucket)
    return q, QuantMeta(w_min, bucket, n, 0), empty


def dequantize(q: torch.Tensor, meta: QuantMeta, outliers=None) -> torch.Tensor:
    """Codes -> flat f32 on ``q``'s device (K9 on the card), outlier
    sidecar applied."""
    w = qops.dequantize_codes(q.reshape(-1).to(torch.int16), meta.w_min,
                              meta.bucket_size)
    if outliers is not None and len(outliers[0]):
        idx = torch.from_numpy(np.asarray(outliers[0]).astype(np.int64))
        w[idx.to(w.device)] = torch.from_numpy(
            np.asarray(outliers[1], np.float32)).to(w.device)
    return w


def max_error(meta: QuantMeta) -> float:
    """Quantization error bound: half a bucket (plus bound-rounding slack)."""
    return 0.5 * meta.bucket_size


# ---------------------------------------------------------------------------
# Int8 row quantization for the serving-resident weights
# ---------------------------------------------------------------------------

ROW_LEVELS = 255  # codes -127..127
LR_BLOCK = 64


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


def _host_rows(w, rows: np.ndarray) -> np.ndarray:
    """Rows ``rows`` of a table (device tensor or array) as host f32."""
    if isinstance(w, torch.Tensor):
        return _np(w[torch.from_numpy(rows).to(w.device)].to(torch.float32))
    return np.asarray(w, np.float32)[rows]


def _scatter(dst: torch.Tensor, idx: np.ndarray, src: np.ndarray) -> None:
    dst[torch.from_numpy(idx).to(dst.device)] = torch.from_numpy(src).to(
        dst.device)


def requantize_rows(qtable, w, row_ranges) -> dict:
    """Requantize only ``row_ranges`` (iterable of ``(start, stop)``) of
    ``w`` into a *copy* of ``qtable``; untouched rows keep byte-identical
    codes/scale/zero (each row's grid depends only on that row's values).

    The copy is a device clone with the touched rows scattered in: the
    previous table stays published to concurrent scorers until the
    engine's atomic swap, so it never mutates. The touched rows travel to
    the host and are quantized there in numpy, as in the JAX package."""
    out = {k: qtable[k].clone() for k in ("codes", "scale", "zero")}
    rows = (np.concatenate([np.arange(r0, r1) for r0, r1 in row_ranges])
            if row_ranges else np.zeros(0, np.int64))
    if rows.size:
        part = quantize_rows(_host_rows(w, rows))
        for k in ("codes", "scale", "zero"):
            _scatter(out[k], rows, part[k])
    return out


def requantize_blocks(qtable: dict, w, elem_ranges) -> dict:
    """Requantize only the blocks covering ``elem_ranges`` (iterable of
    element ``(start, stop)``) of ``w`` into a *copy* of ``qtable``;
    untouched blocks keep byte-identical codes/scale/zero (per-block grids
    are independent). The copy contract matches :func:`requantize_rows`."""
    block = int(qtable["block"])
    out = {k: qtable[k].clone() for k in ("codes", "scale", "zero")}
    out["block"] = block
    v = out["codes"].numel()
    blocks = (np.unique(np.concatenate(
        [np.arange(e0 // block, -(-e1 // block)) for e0, e1 in elem_ranges]))
        if elem_ranges else np.zeros(0, np.int64))
    if blocks.size:
        # the touched blocks' elements (a trailing partial block padded with
        # its own last element, as quantize_blocks pads it, so the grids come
        # out byte-identical to a full requantize) quantized as one vector
        elem = blocks[:, None] * block + np.arange(block)[None, :]
        src = np.minimum(elem, v - 1).reshape(-1)
        part = quantize_blocks(_host_rows(w.reshape(-1), src), block)
        keep = (elem < v).reshape(-1)
        _scatter(out["codes"], elem.reshape(-1)[keep], part["codes"][keep])
        _scatter(out["scale"], blocks, part["scale"])
        _scatter(out["zero"], blocks, part["zero"])
    return out


def quantize_params_rows(params, prev=None, touched_rows=None,
                         paths=ROW_QUANT_PATHS, block_paths=BLOCK_QUANT_PATHS,
                         lr_block: int = LR_BLOCK, stats=None):
    """Serving-side quantize-on-ingest: replace the gather-table leaves of a
    params tree with int8 tables on the leaf's device — per-row grids for
    ``paths`` (the embedding tables), blocked grids for ``block_paths``
    (the LR vector). Every other leaf stays as it is; leaves that are
    already quantized are kept.

    ``prev`` is the previously published quantized params: given together
    with ``touched_rows`` (a dict mapping "/"-joined leaf paths to ``(start,
    stop)`` range lists — rows for row leaves, elements for blocked leaves),
    only those rows/blocks requantize into device copies of the previous
    tables. ``stats`` (a mutable dict) gets ``"rows_requantized"`` /
    ``"blocks_requantized"`` incremented by the work done. Returns a new
    top-level tree; untouched subtrees are shared."""
    out = dict(params)
    for path, blocked in ([(p, False) for p in paths]
                          + [(p, True) for p in block_paths]):
        node = _walk(out, path)
        quantized_already = (is_block_quantized(node) if blocked
                             else is_row_quantized(node))
        if node is None or quantized_already:
            continue
        # copy the subdict chain so the caller's tree is never mutated
        sub = out
        for key in path[:-1]:
            sub[key] = dict(sub[key])
            sub = sub[key]
        pq = None
        if prev is not None:
            pnode = _walk(prev, path)
            fits = (is_block_quantized(pnode) if blocked
                    else is_row_quantized(pnode))
            if fits and tuple(pnode["codes"].shape) == tuple(node.shape) \
                    and (not blocked or int(pnode["block"]) == lr_block):
                pq = pnode
        if pq is not None and touched_rows is not None:
            ranges = touched_rows.get("/".join(path), ())
            if blocked:
                sub[path[-1]] = requantize_blocks(pq, node, ranges)
                blk = set()
                for e0, e1 in ranges:
                    blk.update(range(e0 // lr_block, -(-e1 // lr_block)))
                n_units = len(blk)
            else:
                sub[path[-1]] = requantize_rows(pq, node, ranges)
                n_units = sum(r1 - r0 for r0, r1 in ranges)
        else:
            host = _np(node)
            table = (quantize_blocks(host, lr_block) if blocked
                     else quantize_rows(host))
            sub[path[-1]] = _to_tensors(table, node.device)
            n_units = table["scale"].shape[0] if blocked else host.shape[0]
        if stats is not None:
            key = "blocks_requantized" if blocked else "rows_requantized"
            stats[key] = stats.get(key, 0) + n_units
    return out


def quantized_nbytes(params) -> int:
    """Total resident bytes of a params tree, counting quantized-table dicts
    at their int8+scales size (and, as the JAX package does, a blocked
    table's ``block`` integer as one int64)."""
    if isinstance(params, dict):
        return sum(quantized_nbytes(v) for v in params.values())
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return np.asarray(params).nbytes


# ---------------------------------------------------------------------------
# Byte-level weight-file format (header + payload), as shipped across DCs
# ---------------------------------------------------------------------------

def _codes_u2(q) -> np.ndarray:
    """Codes as host ``<u2`` (a device int16 tensor crosses once)."""
    if isinstance(q, torch.Tensor):
        return _np(q.reshape(-1).to(torch.int16)).view("<u2")
    return np.asarray(q, dtype="<u2")


def to_bytes(q, meta: QuantMeta, outliers=None) -> bytes:
    header = struct.pack(HEADER_FMT, meta.w_min, meta.bucket_size, meta.n,
                         meta.n_outliers)
    body = header + _codes_u2(q).tobytes()
    if meta.n_outliers:
        idx, vals = outliers
        body += np.asarray(idx, "<u8").tobytes() + np.asarray(vals, "<f4").tobytes()
    return body


def from_bytes(buf: bytes):
    w_min, bucket, n, n_out = struct.unpack(HEADER_FMT, buf[:HEADER_SIZE])
    q = np.frombuffer(buf, dtype="<u2", offset=HEADER_SIZE, count=n)
    meta = QuantMeta(w_min, bucket, n, n_out)
    outliers = (np.zeros(0, np.uint64), np.zeros(0, np.float32))
    if n_out:
        off = HEADER_SIZE + 2 * n
        idx = np.frombuffer(buf, dtype="<u8", offset=off, count=n_out)
        vals = np.frombuffer(buf, dtype="<f4", offset=off + 8 * n_out, count=n_out)
        outliers = (idx, vals)
    return q, meta, outliers


def quantize_to_bytes(w: torch.Tensor, alpha: int = 2, beta: int = 2,
                      prev: Optional[QuantMeta] = None) -> bytes:
    q, meta, outliers = quantize(w, alpha, beta, prev=prev)
    return to_bytes(q, meta, outliers)


def dequantize_from_bytes(buf: bytes) -> np.ndarray:
    """Pure-numpy reconstruction: f32 ``min + q * bucket``, a multiply then
    an add. :func:`dequantize` on the card (K9) equals it bit for bit."""
    q, meta, outliers = from_bytes(buf)
    w = (np.float32(meta.w_min)
         + q.astype(np.float32) * np.float32(meta.bucket_size))
    if meta.n_outliers:
        idx, vals = outliers
        w[idx.astype(np.int64)] = vals
    return w
