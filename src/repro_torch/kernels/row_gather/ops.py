"""Row gathers of the serving tables (port of
``repro/kernels/row_gather/ops.py``).

Two strategies, as in the JAX package:

* **On the device**: every gather of a CUDA int8 table runs kernel K1
  (``csrc/row_gather.cu``, :func:`gather_dequant_rows_q8`); a CPU tensor
  gets the plain version. Each call books its work (:func:`k1_work`) with
  an op counter (``launch/op_analysis.py``) through ``_build.booking``.
* **Host packed gather** (:func:`gather_codes_np` /
  :func:`gather_dequant_np`): numpy ``take`` over the widest word view the
  row byte-length allows (int8 rows of 8k bytes move as u64 lanes). The
  serving engine pre-gathers candidate codes, grids and LR terms this way
  when ``InferenceEngine(host_gather=True)`` and feeds the gathered block
  to the candidate kernels.

:func:`use_host_gather` is the engine's auto policy. The JAX package takes
the host gather on its CPU backend past a gather cliff, the table size
above which XLA-CPU's generic gather leaves its fast path, calibrated once
per process (:func:`cliff_rows`). Here the in-process gather on the CPU is
torch's ``index_select``, which the calibration races instead; on the card
the policy is always false and the device gather stays the default.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.row_gather.ref import gather_dequant_rows_q8_ref

# The fallback threshold: the host's real crossover is measured once per
# process by :func:`calibrate_cliff_rows` (``REPRO_CLIFF_CALIBRATE=0`` turns
# the probe off and pins this constant).
CLIFF_ROWS = 1 << 17

# calibration probe bounds: the cliff never moves below 2^16 (small tables
# stay on the in-process gather whatever the micro-timing noise) or above
# 2^20
_PROBE_SIZES = (1 << 16, 1 << 17, 1 << 18, 1 << 19)
_PROBE_MAX = 1 << 20
_calibrated: Optional[int] = None
# the shards of a fleet hit their first gather at once: one probe, one answer
_calibrate_lock = threading.Lock()


def calibrate_cliff_rows(sizes: Sequence[int] = _PROBE_SIZES,
                         row_bytes: int = 192, n_idx: int = 4096,
                         repeats: int = 3) -> int:
    """The smallest probed table size at which the host packed gather
    (:func:`gather_codes_np`) beats torch's ``index_select`` on the CPU on
    an int8 row table of ``row_bytes`` (a 24-field x 8-wide int8 row by
    default); ``_PROBE_MAX`` when ``index_select`` wins everywhere probed.
    :func:`cliff_rows` caches the answer per process."""
    idx = np.random.default_rng(0).integers(0, min(sizes), size=n_idx)
    idx_t = torch.from_numpy(idx)
    for n_rows in sorted(sizes):
        table = np.zeros((n_rows, row_bytes), np.int8)
        table_t = torch.from_numpy(table)
        torch.index_select(table_t, 0, idx_t)  # first call: warm caches
        t_torch = min(_timed(lambda: torch.index_select(table_t, 0, idx_t))
                      for _ in range(repeats))
        t_host = min(_timed(lambda: gather_codes_np(table, idx))
                     for _ in range(repeats))
        if t_host < t_torch:
            return int(n_rows)
    return _PROBE_MAX


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def cliff_rows() -> int:
    """The effective gather-cliff threshold: the per-process calibrated
    crossover, or :data:`CLIFF_ROWS` when probing is disabled
    (``REPRO_CLIFF_CALIBRATE=0``) or the probe fails."""
    if os.environ.get("REPRO_CLIFF_CALIBRATE", "1").lower() in ("0", "false"):
        return CLIFF_ROWS
    global _calibrated
    if _calibrated is None:  # double-checked: reads stay lock-free once set
        with _calibrate_lock:
            if _calibrated is None:
                try:
                    _calibrated = calibrate_cliff_rows()
                except Exception:
                    # a probe failure never breaks engine startup
                    _calibrated = CLIFF_ROWS
    return _calibrated


def use_host_gather(n_rows: int, device) -> bool:
    """True when an engine on ``device`` should pre-gather candidate rows on
    the host: a CPU device (JAX's CPU backend) and a table past the gather
    cliff (:func:`cliff_rows`). False on the card, without a probe; a table
    below the smallest probe size is below every threshold the probe or its
    fallback can return, so it runs no probe either."""
    if torch.device(device).type != "cpu":
        return False
    if n_rows < min(CLIFF_ROWS, *_PROBE_SIZES):
        return False
    return n_rows >= cliff_rows()


def _packed_view(flat: np.ndarray):
    """Widest-word view of a (V, rowbytes) byte-contiguous table: int8 rows
    move as u64/u32/u16 lanes when the row byte-length allows (numpy's take
    copies per element of the *viewed* dtype, so wider is fewer moves)."""
    rowbytes = flat.shape[1] * flat.dtype.itemsize
    for width, dt in ((8, np.uint64), (4, np.uint32), (2, np.uint16)):
        if rowbytes % width == 0:
            return flat.view(dt)
    return flat


def gather_codes_np(table: np.ndarray, idx: np.ndarray,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
    """Host packed row gather: ``table[idx]`` via ``np.take`` on the widest
    aligned word view. ``table``: (V, ...) any dtype; returns
    ``idx.shape + table.shape[1:]`` in the table dtype, written into ``out``
    when given (exactly that shape and dtype; the scoring pool's recycled
    buffers)."""
    table = np.ascontiguousarray(table)
    idx = np.asarray(idx)
    flat = table.reshape(table.shape[0], -1)
    packed = _packed_view(flat)
    if out is None:
        g = np.take(packed, idx.reshape(-1), axis=0)
        return g.view(table.dtype).reshape(idx.shape + table.shape[1:])
    want = idx.shape + table.shape[1:]
    if out.shape != want or out.dtype != table.dtype:
        raise ValueError(
            f"out must be {want} {table.dtype}, got {out.shape} {out.dtype}")
    if idx.size == 0:
        return out
    dst = np.ascontiguousarray(out)  # no-op for a well-formed buffer
    np.take(packed, idx.reshape(-1), axis=0,
            out=_packed_view(dst.reshape(idx.size, -1)))
    if dst is not out:  # a non-contiguous view: copy back
        out[...] = dst
    return out


def gather_codes_chunked(table: np.ndarray, idx: np.ndarray,
                         out: np.ndarray, row_chunk: int = 8192) -> np.ndarray:
    """:func:`gather_codes_np` into ``out``, ``row_chunk`` index rows at a
    time, so the transient packed view never exceeds the chunk. ``idx`` must
    be at least 1-D; ``out`` has shape ``idx.shape + table.shape[1:]`` in
    the table dtype."""
    idx = np.asarray(idx)
    flat_idx = idx.reshape(-1)
    flat_out = out.reshape((flat_idx.size,) + table.shape[1:])
    for lo in range(0, flat_idx.size, max(1, row_chunk)):
        hi = min(lo + row_chunk, flat_idx.size)
        gather_codes_np(table, flat_idx[lo:hi], out=flat_out[lo:hi])
    return out


def gather_dequant_np(qtable, idx: np.ndarray) -> np.ndarray:
    """Host gather + per-row dequantize of an int8 row-quantized table dict
    of numpy arrays (``quantization.quantize_rows`` format) -> f32 rows."""
    idx = np.asarray(idx)
    codes = np.asarray(qtable["codes"])
    extra = (1,) * (codes.ndim - 1)
    c = gather_codes_np(codes, idx).astype(np.float32)
    s = np.asarray(qtable["scale"])[idx].reshape(idx.shape + extra)
    z = np.asarray(qtable["zero"])[idx].reshape(idx.shape + extra)
    return c * s + z


def k1_work(m: int, rowlen: int):
    """(operations, bytes) of K1's function: ``m`` rows of ``rowlen`` int8
    codes, a multiply and an add per code; the codes, the row's index and
    its two f32 grid scalars read, the f32 rows written."""
    return 2 * m * rowlen, m * (rowlen + 4 + 8) + m * rowlen * 4


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
    rowlen = math.prod(codes.shape[1:])
    with _build.booking("gather_dequant_rows_q8",
                        lambda: k1_work(idx.numel(), rowlen)):
        return _call(codes, scale, zero, idx, out, rowlen)


def _call(codes, scale, zero, idx, out, rowlen):
    shape = tuple(idx.shape) + tuple(codes.shape[1:])
    if out is not None and (out.dtype != torch.float32
                            or not out.is_contiguous()
                            or out.numel() != idx.numel() * rowlen):
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
