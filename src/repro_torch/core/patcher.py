"""Byte-level model patching (paper §6; a copy of ``repro/core/patcher.py``).

A patch encodes the byte positions that differ between the old and new weight
files, exploiting the consistent memory layout of the serialized weights
(``repro_torch.checkpoint.layout`` guarantees determinism for any params
tree):

* changed bytes are grouped into runs;
* run starts are stored as **relative** offsets (gap since previous run end) —
  the paper's "instead of storing absolute indices of bytes that change,
  relative locations are stored";
* gaps and run lengths are LEB128 varints — "small integers ... stored as a
  custom integer type - instead of storing whole ints, compressed versions";
* the whole stream is zlib-compressed — "the diffs are compressed, sent to
  the serving layer, unpacked and applied".

Everything is vectorized numpy; producing a patch for a multi-GB buffer takes
seconds (paper budget: 45 s for the full weight space).
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

MAGIC = b"FWPATCH1"


# ---------------------------------------------------------------------------
# Vectorized LEB128 varints
# ---------------------------------------------------------------------------

def varint_encode(values: np.ndarray) -> np.ndarray:
    """uint64 array -> concatenated LEB128 bytes (vectorized)."""
    v = values.astype(np.uint64)
    if v.size == 0:
        return np.zeros(0, np.uint8)
    nbytes = np.ones(v.shape, np.int64)
    for k in range(1, 10):
        nbytes += (v >= (np.uint64(1) << np.uint64(7 * k))).astype(np.int64)
    total = int(nbytes.sum())
    out = np.zeros(total, np.uint8)
    offs = np.concatenate([[0], np.cumsum(nbytes)[:-1]])
    for i in range(int(nbytes.max())):
        mask = nbytes > i
        byte = (v[mask] >> np.uint64(7 * i)) & np.uint64(0x7F)
        cont = ((nbytes[mask] > i + 1).astype(np.uint8)) << 7
        out[offs[mask] + i] = byte.astype(np.uint8) | cont
    return out


def varint_decode(buf: np.ndarray) -> np.ndarray:
    """Concatenated LEB128 bytes -> uint64 array (vectorized)."""
    b = np.asarray(buf, np.uint8)
    if b.size == 0:
        return np.zeros(0, np.uint64)
    is_end = (b & 0x80) == 0
    group = np.zeros(b.size, np.int64)
    group[1:] = np.cumsum(is_end)[:-1]  # group id per byte
    n = int(is_end.sum())
    # position within group
    starts = np.zeros(n, np.int64)
    ends = np.flatnonzero(is_end)
    starts[1:] = ends[:-1] + 1
    pos = np.arange(b.size) - starts[group]
    contrib = (b.astype(np.uint64) & np.uint64(0x7F)) << (np.uint64(7) * pos.astype(np.uint64))
    out = np.zeros(n, np.uint64)
    np.add.at(out, group, contrib)
    return out


# ---------------------------------------------------------------------------
# Run-length byte diff
# ---------------------------------------------------------------------------

def _runs(changed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Boolean mask -> (run_starts, run_lengths)."""
    if not changed.any():
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    d = np.diff(changed.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if changed[0]:
        starts = np.concatenate([[0], starts])
    if changed[-1]:
        ends = np.concatenate([ends, [changed.size]])
    return starts.astype(np.int64), (ends - starts).astype(np.int64)


def diff(old: bytes, new: bytes, compress_level: int = 6) -> bytes:
    """Produce a patch transforming ``old`` into ``new`` (equal lengths)."""
    a = np.frombuffer(old, np.uint8)
    b = np.frombuffer(new, np.uint8)
    if a.size != b.size:
        raise ValueError(f"size mismatch: {a.size} vs {b.size} "
                         "(the weight layout must be consistent across updates)")
    changed = a != b
    starts, lengths = _runs(changed)
    # relative offsets: gap from end of previous run to start of next
    prev_end = np.concatenate([[0], (starts + lengths)[:-1]])
    gaps = (starts - prev_end).astype(np.uint64)
    payload_idx = np.flatnonzero(changed)
    payload = b[payload_idx]
    stream = (
        varint_encode(np.array([starts.size], np.uint64)).tobytes()
        + varint_encode(gaps).tobytes()
        + varint_encode(lengths.astype(np.uint64)).tobytes()
        + payload.tobytes()
    )
    body = zlib.compress(stream, compress_level)
    header = MAGIC + struct.pack("<QQ", a.size, len(body))
    return header + body


def apply_patch(old: bytes, patch: bytes) -> bytes:
    if patch[: len(MAGIC)] != MAGIC:
        raise ValueError("bad patch magic")
    size, body_len = struct.unpack_from("<QQ", patch, len(MAGIC))
    a = np.frombuffer(old, np.uint8).copy()
    if a.size != size:
        raise ValueError(f"patch targets buffer of {size} bytes, got {a.size}")
    stream = np.frombuffer(zlib.decompress(patch[len(MAGIC) + 16 :]), np.uint8)
    # decode: first varint = n_runs; then n gaps, n lengths, then payload
    gaps, lengths, payload = _decode_prefix(stream)
    return _apply_decoded(a, gaps, lengths, payload)


def _decode_prefix(stream: np.ndarray):
    # find varint boundaries incrementally: decode all varints up front by
    # scanning for the payload split. We know the layout: 1 + 2n varints then
    # raw payload. Decode varints greedily until we've read 1 + 2n values.
    is_end = (stream & 0x80) == 0
    ends = np.flatnonzero(is_end)
    first = varint_decode(stream[: ends[0] + 1])
    n = int(first[0])
    need = 1 + 2 * n
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.uint8))
    last_varint_end = ends[need - 1]
    vals = varint_decode(stream[: last_varint_end + 1])
    gaps = vals[1 : 1 + n].astype(np.int64)
    lengths = vals[1 + n : 1 + 2 * n].astype(np.int64)
    payload = stream[last_varint_end + 1 :]
    return gaps, lengths, payload


def _apply_decoded(a: np.ndarray, gaps, lengths, payload) -> bytes:
    if gaps.size == 0:
        return a.tobytes()
    starts = np.cumsum(gaps + np.concatenate([[0], lengths[:-1]]))
    # scatter payload runs
    idx = np.repeat(starts, lengths) + _intra_run_offsets(lengths)
    a[idx] = payload
    return a.tobytes()


def _intra_run_offsets(lengths: np.ndarray) -> np.ndarray:
    """[3, 2] -> [0, 1, 2, 0, 1]."""
    if lengths.size == 0:
        return np.zeros(0, np.int64)
    total = int(lengths.sum())
    out = np.arange(total, dtype=np.int64)
    run_starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return out - np.repeat(run_starts, lengths)


def patch_size(patch: bytes) -> int:
    return len(patch)
