"""A frozen copy of the update wire format, read by the benchmark alone:
the frame header and its CRC, the row-delta body (varint gaps and lengths
plus an XOR payload, both zlib-compressed), and the 16-bit quantized
weight file (``<ffQQ`` header: w_min, bucket, n, outliers; ``<u2`` codes)
with its outlier sidecar. Written against ``checkpoint/transfer.py``,
``core/quantization.py`` and ``core/patcher.py`` as they stood when the
benchmark was written; it imports none of them, so a frame the program
writes wrongly decodes wrongly here.
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

FRAME_MAGIC = 0xFC
FRAME_HDR = "<BBBII"  # magic, kind, mode length, version, base version
KIND_FULL, KIND_PATCH, KIND_DELTA = 0, 1, 2
QUANT_HDR = "<ffQQ"
DELTA_HDR = "<IQ"


try:  # the program's choice of 32-bit CRC, made the same way
    from crc32c import crc32c as _crc32
except ImportError:
    from zlib import crc32 as _crc32


class WireError(ValueError):
    pass


def varint_decode(buf: np.ndarray) -> np.ndarray:
    """Concatenated LEB128 bytes -> uint64 values."""
    b = np.asarray(buf, np.uint8)
    if b.size == 0:
        return np.zeros(0, np.uint64)
    is_end = (b & 0x80) == 0
    group = np.zeros(b.size, np.int64)
    group[1:] = np.cumsum(is_end)[:-1]
    ends = np.flatnonzero(is_end)
    starts = np.concatenate([[0], ends[:-1] + 1])
    pos = (np.arange(b.size) - starts[group]).astype(np.uint64)
    contrib = (b.astype(np.uint64) & np.uint64(0x7F)) << (np.uint64(7) * pos)
    out = np.zeros(ends.size, np.uint64)
    np.add.at(out, group, contrib)
    return out


def unframe(frame: bytes) -> Tuple[int, int, int, bytes, bytes]:
    """-> (kind, version, base_version, sidecar, body), the CRC checked."""
    magic, kind, mlen, version, base = struct.unpack_from(FRAME_HDR, frame, 0)
    if magic != FRAME_MAGIC:
        raise WireError("bad frame magic")
    head_end = struct.calcsize(FRAME_HDR) + mlen
    (want,) = struct.unpack_from("<I", frame, head_end)
    got = _crc32(frame[head_end + 4:], _crc32(frame[:head_end]))
    if got & 0xFFFFFFFF != want:
        raise WireError("frame checksum mismatch")
    payload = frame[head_end + 4:]
    (side_len,) = struct.unpack_from("<Q", payload, 0)
    return kind, version, base, payload[8:8 + side_len], payload[8 + side_len:]


def apply_delta(current: np.ndarray, body: bytes) -> np.ndarray:
    """XOR a row-delta body into a copy of the byte buffer ``current``."""
    hdr = struct.calcsize(DELTA_HDR)
    n, meta_len = struct.unpack_from(DELTA_HDR, body, 0)
    vals = varint_decode(np.frombuffer(
        zlib.decompress(body[hdr:hdr + meta_len]), np.uint8))
    gaps = vals[:n].astype(np.int64)
    lengths = vals[n:2 * n].astype(np.int64)
    starts = np.cumsum(gaps + np.concatenate([[0], lengths[:-1]]))
    xor = np.frombuffer(zlib.decompress(body[hdr + meta_len:]), np.uint8)
    if int(lengths.sum()) != xor.size:
        raise WireError("delta payload does not match its ranges")
    out = current.copy()
    run0 = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    pos = np.repeat(starts - run0, lengths) + np.arange(xor.size)
    out[pos] ^= xor
    return out


class Decoder:
    """Follows a chain of frames (a full one, then deltas) and returns the
    weight space each leaves, as float32 numpy."""

    def __init__(self):
        self.buf = None
        self.version = 0

    def apply(self, frame: bytes) -> None:
        kind, version, base, sidecar, body = unframe(frame)
        if kind == KIND_FULL:
            self.buf = np.frombuffer(body, np.uint8).copy()
        elif kind == KIND_DELTA:
            if self.buf is None or base != self.version:
                raise WireError(f"delta v{version} chains from v{base}, "
                                f"held v{self.version}")
            self.buf = apply_delta(self.buf, body)
        else:
            raise WireError(f"frame kind {kind} not expected here")
        self.version = version
        self.sidecar = sidecar

    def weights(self) -> np.ndarray:
        w_min, bucket, n, _ = struct.unpack_from(QUANT_HDR, self.buf, 0)
        q = np.frombuffer(self.buf, "<u2", count=n,
                          offset=struct.calcsize(QUANT_HDR))
        w = np.float32(w_min) + q.astype(np.float32) * np.float32(bucket)
        if self.sidecar:
            (k,) = struct.unpack_from("<Q", self.sidecar, 0)
            idx = np.frombuffer(self.sidecar, "<u8", count=k, offset=8)
            w[idx.astype(np.int64)] = np.frombuffer(
                self.sidecar, "<f4", count=k, offset=8 + 8 * k)
        self.bucket = float(bucket)
        return w


def split_leaves(flat: np.ndarray, shapes: dict) -> dict:
    """The weight space in the layout's order (leaf paths sorted as
    strings) -> {path: array}."""
    out, pos = {}, 0
    for path in sorted(shapes):
        n = int(np.prod(shapes[path]))
        out[path] = flat[pos:pos + n].reshape(shapes[path])
        pos += n
    if pos != flat.size:
        raise WireError(f"layout holds {pos} weights, the frame {flat.size}")
    return out
