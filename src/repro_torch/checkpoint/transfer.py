"""Trainer -> server weight-update channel (port of
``repro/checkpoint/transfer.py``; paper §3 + §6).

Every online-training round ships a weight update across the network. Four
modes, matching the paper's Table 4 rows:

  ``raw``          — full float weight file               (100%)
  ``quant``        — 16-bit quantized file                (~50%)
  ``patch``        — byte diff of raw files               (~30%)
  ``patch+quant``  — byte diff of quantized files         (~3 +/- 2%)

A trainer that knows which embedding rows it touched ships a **row-delta
frame** (``KIND_DELTA``): the byte ranges of the touched rows plus every
dense leaf, as an XOR against the previous buffer; layout changes, grid
regrids and the first round fall back to full/patch frames. Every frame
carries a CRC over header+mode+body, and patch/delta frames the version
they chain from; decode and apply failures raise the :class:`FrameError`
taxonomy and leave the receiver untouched.

Frames are byte-identical to the JAX package's for the same params
sequence, and each package's receiver applies the other's frames: the
framing, delta codec and patcher are the same numpy code, and the wire
quantizer's codes equal ``_quantize_core``'s bit for bit.

Device work: :class:`Sender` concatenates the weight space on its device
(``None``: the card) and quantizes it there (kernels K7 ``minmax`` and K8
``quantize_codes``); the codes cross to the host once. :class:`Receiver`
applies frames to its host byte buffer and dequantizes on its device
(kernel K9 ``dequantize_codes``): a full decode uploads every code, an
incremental decode after row deltas only the touched ones, scattered into a
clone of the previous device flat. :class:`ShardedSender` quantizes the
weight space once and frames a slice of it per shard of a fleet.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import layout
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import patcher, quantization as Q
from repro_torch.kernels.quantize import ops as qops

MODES = ("raw", "quant", "patch", "patch+quant")

KIND_FULL, KIND_PATCH, KIND_DELTA = 0, 1, 2

_KIND_STR = {KIND_FULL: "full", KIND_PATCH: "patch", KIND_DELTA: "delta"}


class FrameError(ValueError):
    """A transfer frame could not be decoded or safely applied.

    Subclasses distinguish *why* so callers can react (count, NACK, request
    a resync) instead of treating a wire fault like a programming bug.
    ``ValueError`` base keeps pre-taxonomy callers working.
    """


class TruncatedFrameError(FrameError):
    """Frame bytes end before the header/sidecar/body they promise."""


class FrameChecksumError(FrameError):
    """Stored CRC does not match the received header+mode+body bytes."""


class VersionRegressionError(FrameError):
    """Frame is stale, replayed, or chains from a version the receiver
    does not hold (a frame in between was lost) — NACK and resync."""


class LayoutMismatchError(FrameError):
    """Frame decodes but does not fit the receiver's weight buffer
    (layout skew between trainer and server)."""


# CRC implementation: prefer a real CRC32C (Castagnoli) extension when the
# environment has one; otherwise fall back to zlib's C-speed CRC-32. Both are
# 32-bit CRCs with the same error-detection class for our frame sizes — the
# polynomial choice only matters for cross-implementation interop. The JAX
# package makes the same choice, so both packages agree on one machine.
try:  # pragma: no cover - absent in the pinned environment
    from crc32c import crc32c as _crc32
except ImportError:
    from zlib import crc32 as _crc32


def frame_checksum(data: bytes, value: int = 0) -> int:
    """Running 32-bit CRC over ``data``, seeded with ``value``."""
    return _crc32(data, value) & 0xFFFFFFFF


@dataclass(frozen=True)
class UpdateFrame:
    """Decoded update header — the public view of one trainer->server blob.

    ``version`` is the trainer's monotonic round stamp (``Sender.make_update``
    auto-increments it; a trainer may stamp its round counter), letting the
    serving layer tag cache generations without re-deriving state from bytes.
    """

    kind: int        # KIND_FULL | KIND_PATCH | KIND_DELTA
    mode: str        # one of MODES
    version: int     # trainer round stamp, monotonically increasing
    payload: bytes   # framed sidecar + diffable body
    # version of the sender's previous frame — the state a patch/delta chains
    # from. The receiver rejects a chained frame whose base is not the version
    # it holds: that is exactly "a frame in between was lost/corrupted", and
    # applying the XOR anyway would silently poison every later delta.
    base_version: int = 0

    @property
    def is_patch(self) -> bool:
        return self.kind == KIND_PATCH

    @property
    def is_delta(self) -> bool:
        return self.kind == KIND_DELTA


_FRAME_MAGIC = 0xFC  # guards against version-skewed / foreign blobs

# header: magic u8, kind u8, mode-length u8, version u32, base_version u32;
# then the mode string, a u32 CRC over header+mode+body, then the body
_FRAME_HDR = "<BBBII"
_FRAME_HDR_SIZE = struct.calcsize(_FRAME_HDR)


def _frame(kind: int, mode: str, body: bytes, version: int = 0,
           base_version: int = 0) -> bytes:
    m = mode.encode()
    head = struct.pack(_FRAME_HDR, _FRAME_MAGIC, kind, len(m), version,
                       base_version) + m
    # running CRC (header first, then body) avoids concatenating a copy of
    # the (potentially many-MB) body just to checksum it
    crc = frame_checksum(body, frame_checksum(head))
    return head + struct.pack("<I", crc) + body


def unframe(update: bytes) -> UpdateFrame:
    """Decode + integrity-check an update blob's header (public API — serving
    must not parse bytes). Raises the :class:`FrameError` taxonomy on bad
    bytes; never a raw ``struct.error``."""
    try:
        magic, kind, mlen, version, base_version = struct.unpack_from(
            _FRAME_HDR, update, 0)
    except struct.error as e:
        raise TruncatedFrameError(
            f"frame truncated inside the header ({len(update)} bytes)") from e
    if magic != _FRAME_MAGIC:
        raise FrameError("not a transfer update frame (bad magic byte)")
    head_end = _FRAME_HDR_SIZE + mlen
    if len(update) < head_end + 4:
        raise TruncatedFrameError("frame truncated before the checksum")
    try:
        mode = bytes(update[_FRAME_HDR_SIZE:head_end]).decode()
    except UnicodeDecodeError as e:
        raise FrameError("corrupt mode string in frame header") from e
    (want,) = struct.unpack_from("<I", update, head_end)
    got = frame_checksum(update[head_end + 4:],
                         frame_checksum(update[:head_end]))
    if got != want:
        raise FrameChecksumError(
            f"frame checksum mismatch (stored {want:#010x}, "
            f"computed {got:#010x})")
    return UpdateFrame(kind, mode, version, update[head_end + 4:],
                       base_version)


# ---------------------------------------------------------------------------
# Row-delta frame body: sorted byte ranges (varint gap/length) + XOR payload
# ---------------------------------------------------------------------------

_DELTA_HDR = "<IQ"  # (n_ranges: u32, compressed varint-metadata length: u64)


def _encode_delta(starts: np.ndarray, lengths: np.ndarray, old: bytes,
                  new: bytes, compress_level: int = 6) -> bytes:
    """Ranges (sorted, non-overlapping byte spans) -> delta body.

    Gap encoding mirrors the patcher ("relative locations are stored"), but a
    range is a whole touched row — one varint pair per row instead of one per
    contiguous changed-byte run. The payload is ``old XOR new`` over the
    ranges: steady-state AdaGrad steps move a 16-bit quantized code by a few
    buckets, so the XOR stream is mostly zero high bytes and low-entropy low
    bytes — zlib collapses it well below the raw changed bytes a byte-diff
    ships, and the trick is mode-agnostic (close floats zero their shared
    exponent/mantissa prefix the same way).
    """
    prev_end = np.concatenate([[0], (starts + lengths)[:-1]])
    gaps = (starts - prev_end).astype(np.uint64)
    meta = zlib.compress(
        patcher.varint_encode(gaps).tobytes()
        + patcher.varint_encode(lengths.astype(np.uint64)).tobytes(),
        compress_level)
    a = np.frombuffer(old, np.uint8)
    b = np.frombuffer(new, np.uint8)
    payload = (np.concatenate([a[s:s + n] ^ b[s:s + n]
                               for s, n in zip(starts, lengths)])
               if starts.size else np.zeros(0, np.uint8))
    return (struct.pack(_DELTA_HDR, starts.size, len(meta)) + meta
            + zlib.compress(payload.tobytes(), compress_level))


def _decode_delta(body: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Delta body -> (starts, lengths, XOR payload bytes)."""
    hdr = struct.calcsize(_DELTA_HDR)
    n, meta_len = struct.unpack_from(_DELTA_HDR, body, 0)
    meta = np.frombuffer(zlib.decompress(body[hdr:hdr + meta_len]), np.uint8)
    vals = patcher.varint_decode(meta)
    gaps = vals[:n].astype(np.int64)
    lengths = vals[n:2 * n].astype(np.int64)
    starts = np.cumsum(gaps + np.concatenate([[0], lengths[:-1]]))
    payload = np.frombuffer(zlib.decompress(body[hdr + meta_len:]), np.uint8)
    return starts, lengths, payload


def _merge_ranges(starts: np.ndarray, lengths: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Sort byte ranges and coalesce adjacent/contiguous ones."""
    if starts.size == 0:
        return starts.astype(np.int64), lengths.astype(np.int64)
    order = np.argsort(starts, kind="stable")
    starts, lengths = starts[order], lengths[order]
    ends = starts + lengths
    # a range opens a new merged run iff it does not touch the previous end
    new_run = np.ones(starts.size, bool)
    new_run[1:] = starts[1:] > np.maximum.accumulate(ends[:-1])
    run_starts = starts[new_run]
    run_ends = np.maximum.reduceat(ends, np.flatnonzero(new_run))
    return run_starts.astype(np.int64), (run_ends - run_starts).astype(np.int64)


def _host_rows(rows) -> np.ndarray:
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    return np.asarray(rows, np.int64)


@dataclass
class Sender:
    """Training-job side: turns a params tree (nested dicts of tensors) into
    a (small) update blob. Quantizing modes concatenate and quantize the
    weight space on ``device`` (``None``: the card)."""

    mode: str = "patch+quant"
    alpha: int = 2
    beta: int = 2
    version: int = 0
    device: DeviceLike = None
    _last: Optional[bytes] = None
    _last_sidecar: bytes = b""
    _last_meta: Optional[Q.QuantMeta] = None
    manifest: Any = None
    _leaf_info: Optional[List[Tuple[str, int, int, int, int, tuple]]] = None

    def _set_layout(self, manifest) -> None:
        """Install a wire layout: the manifest plus the per-leaf info used by
        row-delta framing (element offset into the concatenated weight space
        and byte offset into the raw buffer). A function of shapes and
        dtypes only."""
        self.manifest = manifest
        info, elem_off = [], 0
        for ent in manifest:
            n = int(np.prod(ent["shape"]) or 1)
            itemsize = layout.torch_dtype(ent["dtype"]).itemsize
            info.append((ent["path"], elem_off, ent["offset"], itemsize, n,
                         tuple(ent["shape"])))
            elem_off += n
        self._leaf_info = info

    def _serialize(self, params) -> Tuple[bytes, bytes]:
        """-> (fixed-length diffable buffer, variable-length sidecar)."""
        flat = layout.flatten_with_paths(params)
        self._set_layout(layout.manifest_of(params))
        if "quant" in self.mode:
            # the full weight space, concatenated and quantized on the card
            # each round; grid hysteresis keeps codes byte-stable across
            # online updates. Outliers (weights outside the reused grid)
            # ride in a separate variable-length sidecar so the diffable
            # buffer stays fixed-length across updates.
            dev = resolve_device(self.device)
            w = torch.cat([a.to(dev).reshape(-1).to(torch.float32)
                           for _, a in flat])
            q, meta, outliers = Q.quantize(w, self.alpha, self.beta,
                                           prev=self._last_meta)
            self._last_meta = meta
            fixed = Q.to_bytes(q, Q.QuantMeta(meta.w_min, meta.bucket_size, meta.n, 0))
            sidecar = b""
            if meta.n_outliers:
                idx, vals = outliers
                sidecar = (struct.pack("<Q", meta.n_outliers)
                           + np.asarray(idx, "<u8").tobytes()
                           + np.asarray(vals, "<f4").tobytes())
            return fixed, sidecar
        return b"".join(layout.tensor_bytes(a) for _, a in flat), b""

    def _touched_byte_ranges(self, touched: Dict[str, Any]
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Touched rows per leaf path -> merged (starts, lengths) byte ranges
        of the serialized buffer. Leaves absent from ``touched`` are dense —
        their whole span ships. Quantized buffers are 2 bytes/element after
        the header; raw buffers use each leaf's manifest offset/itemsize."""
        quant = "quant" in self.mode
        known = {path for path, *_ in self._leaf_info}
        unknown = set(touched) - known
        if unknown:
            raise ValueError(f"touched paths not in layout: {sorted(unknown)}")
        starts, lengths = [], []
        for path, elem_off, byte_off, itemsize, n_elems, shape in self._leaf_info:
            rows = touched.get(path)
            if quant:
                base, bpe = Q.HEADER_SIZE + 2 * elem_off, 2
            else:
                base, bpe = byte_off, itemsize
            if rows is None or len(shape) < 1:
                starts.append(np.asarray([base], np.int64))
                lengths.append(np.asarray([bpe * n_elems], np.int64))
                continue
            rows = np.unique(_host_rows(rows))
            if rows.size and (rows[0] < 0 or rows[-1] >= shape[0]):
                raise ValueError(f"touched rows out of range for {path!r}")
            row_elems = n_elems // max(shape[0], 1)
            starts.append(base + rows * (bpe * row_elems))
            lengths.append(np.full(rows.size, bpe * row_elems, np.int64))
        return _merge_ranges(np.concatenate(starts), np.concatenate(lengths))

    def make_update(self, params, version: Optional[int] = None,
                    touched: Optional[Dict[str, Any]] = None) -> bytes:
        """Emit one versioned update blob.

        ``version`` (the trainer's round stamp) defaults to auto-increment;
        explicit stamps must be strictly monotonic (enforced — a stale stamp
        would corrupt the serving engine's generation bookkeeping).

        ``touched`` maps leaf paths (``layout.path_str`` keys) to the row
        indices the trainer updated this round; leaves not listed are treated
        as dense and ship whole. When given — and the layout and quantization
        grid are unchanged since the last update — a ``KIND_DELTA`` frame is
        emitted whose bytes scale with rows touched; otherwise the usual
        full/patch framing applies.
        """
        if version is not None and version <= self.version:
            raise ValueError(
                f"non-monotonic update version {version} (last shipped "
                f"{self.version}); round stamps must strictly increase")
        cur, sidecar = self._serialize(params)
        return self._frame_from(cur, sidecar, touched, version)

    def _frame_from(self, cur: bytes, sidecar: bytes,
                    touched: Optional[Dict[str, Any]] = None,
                    version: Optional[int] = None) -> bytes:
        """Frame an already-serialized ``(fixed buffer, sidecar)`` pair:
        delta/patch/full selection, grid-stability check, version stamping.
        Split from :meth:`make_update` so :class:`ShardedSender` can
        serialize the weight space once and frame per-shard slices of it
        through per-shard senders (each with its shard's ``_last`` buffer
        and leaf layout)."""
        comparable = self._last is not None and len(self._last) == len(cur)
        # a quant-grid regrid changes codes of untouched rows too: the delta
        # precondition is a byte-identical header (grid hysteresis makes this
        # the steady state), else fall back to a full-space frame
        grid_stable = (comparable and
                       ("quant" not in self.mode
                        or cur[:Q.HEADER_SIZE] == self._last[:Q.HEADER_SIZE]))
        if touched is not None and grid_stable:
            starts, lens = self._touched_byte_ranges(touched)
            body, kind = _encode_delta(starts, lens, self._last, cur), KIND_DELTA
        elif "patch" in self.mode and comparable:
            body, kind = patcher.diff(self._last, cur), KIND_PATCH
        else:
            # first round (or layout change) ships the full file
            body, kind = cur, KIND_FULL
        base = self.version  # the state a patch/delta chains from
        self._last, self._last_sidecar = cur, sidecar
        self.version = self.version + 1 if version is None else version
        framed_side = struct.pack("<Q", len(sidecar)) + sidecar
        return _frame(kind, self.mode, framed_side + body,
                      version=self.version, base_version=base)

    def resync_frame(self) -> bytes:
        """The NACK answer: a ``KIND_FULL`` frame of the *last shipped* state,
        rebuilt from the retained ``_last`` buffer + sidecar at the current
        version. State-preserving — ``_last`` and ``version`` are untouched,
        so the next :meth:`make_update` delta chains off the resync'd state
        exactly as it would have off the lost frame."""
        if self._last is None:
            raise RuntimeError(
                "nothing shipped yet — no retained state to resync from")
        framed_side = struct.pack("<Q", len(self._last_sidecar)) + self._last_sidecar
        return _frame(KIND_FULL, self.mode, framed_side + self._last,
                      version=self.version)


# ---------------------------------------------------------------------------
# Sharded fan-out sender
# ---------------------------------------------------------------------------

@dataclass
class ShardedSender:
    """Trainer-side fan-out for a hash-space-sharded serving fleet.

    One :meth:`make_updates` call serializes and wire-quantizes the weight
    space **once** (on ``device``: kernels K7 and K8, the shared 16-bit grid
    and its hysteresis kept at the global level, as one :class:`Sender`
    keeps them), then slices the fixed buffer into per-shard local buffers
    and frames each through a per-shard inner ``Sender`` (local ``_last``
    history, local leaf layout). Hence:

    * **byte exactness** — shard ``s``'s frame decodes to exactly the rows
      ``[lo_s, hi_s)`` of what the full-space frame decodes to: every local
      code byte *is* the global code byte (one global quantization, sliced
      after);
    * **delta filtering by row-range intersection** — the trainer's
      ``touched`` rows are intersected with each shard's range before
      framing; a shard that saw no update still gets a (near-empty) delta,
      so every shard's version chain stays in lockstep;
    * **grid coherence** — every local header derives from the global one,
      so all shards emit deltas in a round or none does.

    ``ranges`` are the fleet topology's row ranges
    (:func:`repro_torch.launch.topology.shard_ranges`), ``row_paths`` the
    row-sharded manifest paths; other leaves replicate into every shard's
    frame. Frames are byte-equal to the JAX package's ``ShardedSender``'s
    for the same params sequence. ``faults`` takes a
    :class:`repro_torch.serving.faults.FaultPlan`: frames pass through its
    ``corrupt_frame(shard, frame)`` on the way out.
    """

    ranges: Any = None
    row_paths: Tuple[str, ...] = ()
    mode: str = "patch+quant"
    version: int = 0
    device: DeviceLike = None
    faults: Any = None
    _global: Optional[Sender] = None
    _shard_senders: Optional[List[Sender]] = None

    def __post_init__(self):
        if not self.ranges:
            raise ValueError("ShardedSender needs the fleet's shard ranges")
        self.ranges = [(int(lo), int(hi)) for lo, hi in self.ranges]
        self.row_paths = tuple(self.row_paths)
        # the global sender carries the one wire-quantization grid; it never
        # frames, so it keeps no _last buffer
        self._global = Sender(mode=self.mode, device=self.device)
        self._shard_senders = [Sender(mode=self.mode, device=self.device)
                               for _ in self.ranges]

    @property
    def manifests(self) -> List[List[Dict[str, Any]]]:
        """Per-shard local manifests (what each shard's receiver decodes
        against); available after :meth:`prime` or the first
        :meth:`make_updates`."""
        return [s.manifest for s in self._shard_senders]

    def _check_row_paths(self) -> None:
        known = {e["path"] for e in self._global.manifest}
        unknown = [p for p in self.row_paths if p not in known]
        if unknown:
            raise ValueError(f"row-sharded paths not in layout: {unknown}")

    def prime(self, like_params) -> None:
        """Publish the wire layout before any round is serialized (from the
        shapes and dtypes of ``like_params``), so :attr:`manifests` can
        configure the fleet's decode pipes before the first round."""
        self._global._set_layout(layout.manifest_of(like_params))
        self._check_row_paths()
        for sender, (lo, hi) in zip(self._shard_senders, self.ranges):
            sender.manifest, sender._leaf_info = self._local_layout(lo, hi)

    def _spans(self, lo: int, hi: int):
        """Per global leaf: ``(leaf info, first global element, element
        count)`` of the shard's part (rows ``[lo, hi)`` of a row-sharded
        leaf, the whole of any other)."""
        for info in self._global._leaf_info:
            path, elem_off, _, _, n, shape = info
            if path in self.row_paths:
                row_elems = n // max(shape[0], 1)
                yield info, elem_off + lo * row_elems, (hi - lo) * row_elems
            else:
                yield info, elem_off, n

    def _local_layout(self, lo: int, hi: int):
        """The global manifest and leaf layout cut down to one shard, offsets
        recomputed in the same sorted-path order."""
        entries = {e["path"]: e for e in self._global.manifest}
        manifest, info = [], []
        byte_off = elem_off = 0
        for (path, _, _, itemsize, n, shape), _, l_n in self._spans(lo, hi):
            l_shape = ((hi - lo,) + tuple(shape[1:]) if path in self.row_paths
                       else tuple(shape))
            manifest.append({"path": path, "dtype": entries[path]["dtype"],
                             "shape": list(l_shape), "offset": byte_off,
                             "nbytes": l_n * itemsize})
            info.append((path, elem_off, byte_off, itemsize, l_n, l_shape))
            byte_off += l_n * itemsize
            elem_off += l_n
        return manifest, info

    def _slice_fixed(self, cur: bytes, lo: int, hi: int,
                     local_n: int) -> bytes:
        """Shard-local fixed buffer: the global buffer's bytes of the
        shard's spans, behind a local header (quant modes)."""
        quant = "quant" in self.mode
        chunks = []
        if quant:
            w_min, bucket, _, _ = struct.unpack_from(Q.HEADER_FMT, cur, 0)
            chunks.append(struct.pack(Q.HEADER_FMT, w_min, bucket, local_n, 0))
        for (_, elem_off, byte_off, itemsize, _, _), e0, m in \
                self._spans(lo, hi):
            if quant:
                chunks.append(cur[Q.HEADER_SIZE + 2 * e0:
                                  Q.HEADER_SIZE + 2 * (e0 + m)])
            else:
                b0 = byte_off + (e0 - elem_off) * itemsize
                chunks.append(cur[b0: b0 + m * itemsize])
        return b"".join(chunks)

    def _slice_sidecar(self, sidecar: bytes, lo: int, hi: int) -> bytes:
        """Shard-local outlier sidecar: the outliers inside the shard's
        spans, remapped to local element indices."""
        if not sidecar:
            return b""
        (n_out,) = struct.unpack_from("<Q", sidecar, 0)
        idx = np.frombuffer(sidecar, "<u8", count=n_out, offset=8)
        vals = np.frombuffer(sidecar, "<f4", count=n_out,
                             offset=8 + 8 * n_out)
        keep_idx, keep_vals = [], []
        l_elem_off = 0
        for _, g0, m in self._spans(lo, hi):
            sel = (idx >= g0) & (idx < g0 + m)
            if sel.any():
                keep_idx.append(idx[sel] - g0 + l_elem_off)
                keep_vals.append(vals[sel])
            l_elem_off += m
        if not keep_idx:
            return b""
        ki = np.concatenate(keep_idx).astype("<u8")
        kv = np.concatenate(keep_vals).astype("<f4")
        return struct.pack("<Q", ki.size) + ki.tobytes() + kv.tobytes()

    def _local_touched(self, touched: Optional[Dict[str, Any]], lo: int,
                       hi: int) -> Optional[Dict[str, Any]]:
        """The trainer's touched rows intersected with ``[lo, hi)`` and
        rebased to local rows. An empty intersection stays in the dict as an
        empty set: "this leaf ships zero rows", not "this leaf is dense"."""
        if touched is None:
            return None
        out = {}
        for path, rows in touched.items():
            if path in self.row_paths:
                rows = _host_rows(rows)
                rows = rows[(rows >= lo) & (rows < hi)] - lo
            out[path] = rows
        return out

    def make_updates(self, params, version: Optional[int] = None,
                     touched: Optional[Dict[str, Any]] = None
                     ) -> List[Optional[bytes]]:
        """One versioned update frame *per shard*, in shard order: per
        shard what :meth:`Sender.make_update` makes of that shard's slice
        of the weight space. ``touched`` rows are full-space. A fault plan
        may turn a frame into ``None`` (dropped) or mangle its bytes."""
        if version is not None and version <= self.version:
            raise ValueError(
                f"non-monotonic update version {version} (last shipped "
                f"{self.version}); round stamps must strictly increase")
        cur, sidecar = self._global._serialize(params)
        self._check_row_paths()
        frames = []
        for sender, (lo, hi) in zip(self._shard_senders, self.ranges):
            sender.manifest, sender._leaf_info = self._local_layout(lo, hi)
            local_n = sum(info[4] for info in sender._leaf_info)
            frames.append(sender._frame_from(
                self._slice_fixed(cur, lo, hi, local_n),
                self._slice_sidecar(sidecar, lo, hi),
                self._local_touched(touched, lo, hi), version))
        self.version = self.version + 1 if version is None else version
        if self.faults is not None:
            # each inner sender's chain already advanced, as for a frame
            # lost on the wire after it was sent
            frames = [self.faults.corrupt_frame(s, f)
                      for s, f in enumerate(frames)]
        return frames

    def resync(self, shard: int) -> bytes:
        """Answer a shard's NACK: a full frame rebuilt from that shard's
        retained last-shipped slice (:meth:`Sender.resync_frame`)."""
        return self._shard_senders[shard].resync_frame()


def _upload_codes(q: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host ``<u2`` codes -> an int16 tensor on ``device``, in one copy."""
    return torch.from_numpy(np.array(q.view(np.int16))).to(device)


@dataclass
class Receiver:
    """Serving side: reconstructs the current inference weights — the frame
    bytes on the host, the decoded weights on ``device`` (``None``: the
    card)."""

    _current: Optional[bytes] = None

    _sidecar: Optional[bytes] = None

    version: int = 0  # stamp of the last applied update
    mode: Optional[str] = None
    device: DeviceLike = None
    # union of byte ranges changed by delta frames *since the last
    # materialize* (None = unknown/full), plus the last materialized flat f32
    # space on the device: together they enable *incremental*
    # dequantization — decode cost scales with rows touched, like the frame.
    # Several deltas may land between materialize calls; their ranges
    # accumulate. Any full/patch frame resets to "unknown" (full decode).
    _delta_ranges: Optional[Tuple[np.ndarray, np.ndarray]] = None
    _flat: Optional[torch.Tensor] = None
    # element ranges of the concatenated weight space the last materialize
    # actually re-decoded: a list of (start_elem, n_elems) when the decode
    # was incremental, None when it was a full decode. The serving layer's
    # quantize-on-ingest uses this to requantize only touched embedding
    # rows. Includes the outlier sidecar's element indices (this frame's and
    # the previous one's): a sidecar value can change — or revert to its
    # grid value — without any byte of the diffable buffer changing, so
    # those elements never appear in the delta ranges yet their
    # reconstruction moved.
    last_touched_elems: Optional[List[Tuple[int, int]]] = None
    _prev_sidecar_elems: Optional[np.ndarray] = None

    def apply_update(self, update: bytes) -> bytes:
        """Apply one frame. Raises the :class:`FrameError` taxonomy on bad
        bytes or a broken version chain, and a *rejected frame mutates
        nothing* — the receiver stays on its current state so a resync (or
        the retransmitted frame) applies cleanly afterwards."""
        frame = unframe(update)
        payload = frame.payload
        try:
            (side_len,) = struct.unpack_from("<Q", payload, 0)
        except struct.error as e:
            raise TruncatedFrameError(
                "frame payload truncated before the sidecar length") from e
        if len(payload) < 8 + side_len:
            raise TruncatedFrameError("frame sidecar truncated")
        sidecar = payload[8 : 8 + side_len]
        body = payload[8 + side_len :]
        kind = _KIND_STR.get(frame.kind, f"kind={frame.kind}")
        if frame.is_patch or frame.is_delta:
            if self._current is None:
                raise FrameError(
                    f"{kind} received before any full weight file")
            if frame.base_version != self.version:
                raise VersionRegressionError(
                    f"{kind} frame v{frame.version} chains from "
                    f"v{frame.base_version} but receiver holds v{self.version}"
                    " — a frame was lost or replayed; resync required")
        elif frame.version < self.version:
            raise VersionRegressionError(
                f"stale full frame v{frame.version} behind receiver "
                f"v{self.version}")
        if frame.is_patch:
            try:
                new_current = patcher.apply_patch(self._current, body)
            except (struct.error, zlib.error, IndexError, ValueError) as e:
                raise TruncatedFrameError(f"corrupt patch body: {e}") from e
            self._current = new_current
            self._delta_ranges = None
        elif frame.is_delta:
            try:
                starts, lengths, xor = _decode_delta(body)
            except (struct.error, zlib.error, IndexError, ValueError) as e:
                raise TruncatedFrameError(f"corrupt delta body: {e}") from e
            cur = np.frombuffer(self._current, np.uint8).copy()
            if starts.size and int(starts[-1] + lengths[-1]) > cur.size:
                raise LayoutMismatchError(
                    "row delta exceeds current weight buffer "
                    "(layout skew between trainer and server)")
            if int(lengths.sum()) != xor.size:
                raise TruncatedFrameError(
                    "row delta XOR payload shorter than its ranges")
            pos = 0
            for s, n in zip(starts, lengths):
                cur[s:s + n] ^= xor[pos:pos + n]
                pos += n
            self._current = cur.tobytes()
            if self._delta_ranges is not None:
                # several deltas between materialize calls: union the ranges.
                # (When None — no materialize since the last full/patch frame
                # — _flat is stale and must NOT be re-armed by a delta; the
                # next materialize decodes fully and resets the accumulator.)
                self._delta_ranges = _merge_ranges(
                    np.concatenate([self._delta_ranges[0], starts]),
                    np.concatenate([self._delta_ranges[1], lengths]))
        else:
            self._current = body
            self._delta_ranges = None
        self._sidecar = sidecar
        self.version, self.mode = frame.version, frame.mode
        return self._current

    def materialize(self, manifest=None, like=None):
        """Decode current bytes (in the mode of the last applied frame) into
        ``{path: tensor}`` on the receiver's device, or, with a ``like`` tree
        (leaves: tensors, arrays or torch dtypes), into its nested-dict
        structure and leaf dtypes. A quantized decode is one K9 launch per
        call (none for a delta that touched nothing).
        """
        if self._current is None:
            raise ValueError("no update applied yet — apply_update first")
        buf = self._current
        dev = resolve_device(self.device)
        if "quant" not in self.mode:
            self.last_touched_elems = None  # raw decode: no incremental tracking
            return layout.from_bytes(buf, manifest, like=like, device=dev)
        q, meta, outliers = Q.from_bytes(buf)
        side_idx = np.zeros(0, np.int64)
        if self._sidecar:
            (n_out,) = struct.unpack_from("<Q", self._sidecar, 0)
            side_idx = np.frombuffer(self._sidecar, "<u8", count=n_out,
                                     offset=8).astype(np.int64)
        if (self._delta_ranges is not None and self._flat is not None
                and self._flat.numel() == meta.n):
            # incremental: only the delta frames' byte ranges changed codes
            # — upload just those codes, dequantize them in one launch and
            # scatter them into a clone of the previous flat space (pure
            # grid values; the sidecar is reapplied below)
            self.last_touched_elems = [
                (int((s - Q.HEADER_SIZE) // 2), int(n // 2))
                for s, n in zip(*self._delta_ranges)]
            elems = (np.concatenate([np.arange(e0, e0 + en) for e0, en
                                     in self.last_touched_elems])
                     if self.last_touched_elems else np.zeros(0, np.int64))
            w = self._flat.clone()
            if elems.size:
                w[torch.from_numpy(elems).to(dev)] = qops.dequantize_codes(
                    _upload_codes(q[elems], dev), meta.w_min,
                    meta.bucket_size)
            # union the outlier-sidecar element indices (current frame's and
            # the previous materialize's — an exiting outlier reverts to its
            # grid value) into the touched set: sidecar values move without
            # touching the diffable bytes (see field comment)
            prev_side = self._prev_sidecar_elems
            both = (np.union1d(side_idx, prev_side)
                    if prev_side is not None and prev_side.size
                    else np.unique(side_idx))
            self.last_touched_elems.extend(
                (int(i), 1) for i in both if i < meta.n)
        else:
            self.last_touched_elems = None
            w = qops.dequantize_codes(_upload_codes(q, dev),
                                      meta.w_min, meta.bucket_size)
            if meta.n_outliers:
                w[torch.from_numpy(outliers[0].astype(np.int64)).to(dev)] = \
                    torch.from_numpy(outliers[1].copy()).to(dev)
        self._flat = w
        # fresh accumulation point: deltas landing after this materialize
        # union into an empty range set against the new _flat; the sidecar
        # snapshot pairs with it
        self._delta_ranges = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        self._prev_sidecar_elems = side_idx
        if side_idx.size:
            n_out = side_idx.size
            vals = np.frombuffer(self._sidecar, "<f4", count=n_out,
                                 offset=8 + 8 * n_out)
            w = w.clone()
            w[torch.from_numpy(side_idx).to(dev)] = torch.from_numpy(
                vals.copy()).to(dev)
        # re-split per manifest entry (views of the flat space)
        out, pos = {}, 0
        for ent in manifest:
            n = int(np.prod(ent["shape"]) or 1)
            out[ent["path"]] = w[pos:pos + n].reshape(ent["shape"])
            pos += n
        return out if like is None else layout.restructure(out, like)
