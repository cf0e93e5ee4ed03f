"""Deterministic flat byte layout for weight trees (port of
``repro/checkpoint/layout.py``; paper §3/§6 substrate).

The byte-level patcher only works because "a consistent memory-level
structure of weight files" holds across updates. Leaves of a params tree
(nested dicts of tensors) serialize in sorted ``"a/b"`` path order with a
manifest recording (path, dtype, shape, offset, nbytes); two checkpoints of
the same model always produce byte-aligned buffers. Paths, order, dtype
names and manifest entries are those of the JAX package, so a manifest and
a buffer cross between the packages: dtype names are numpy's (``"float32"``,
``"int8"``, ...), and a bfloat16 leaf serializes as its raw two bytes under
``"bfloat16"`` (ml_dtypes' name) without needing ml_dtypes.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device


def dtype_name(dtype: torch.dtype) -> str:
    """Manifest name of a torch dtype (numpy's / ml_dtypes' name)."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    """Torch dtype of a manifest dtype name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown manifest dtype {name!r}")
    return dt


def leaf_dtype(leaf) -> torch.dtype:
    """Dtype of a ``like`` leaf: a torch dtype, a tensor or an array."""
    if isinstance(leaf, torch.dtype):
        return leaf
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch_dtype(np.asarray(leaf).dtype.name)


def path_str(path) -> str:
    """Canonical ``"a/b/c"`` string of a key path — the manifest key, part
    of the wire contract on both sides of the transfer channel."""
    return "/".join(str(p) for p in path)


def leaves(tree, prefix: tuple = ()) -> Iterator[Tuple[tuple, Any]]:
    """``(key path, leaf)`` of every leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from leaves(sub, prefix + (key,))
    else:
        yield prefix, tree


def _as_tensor(leaf) -> torch.Tensor:
    # non-tensor leaves go through numpy, so a Python int is int64 and a
    # float float64, as np.asarray makes them in the JAX package
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))


def flatten_with_paths(tree) -> List[Tuple[str, torch.Tensor]]:
    out = [(path_str(p), _as_tensor(leaf)) for p, leaf in leaves(tree)]
    out.sort(key=lambda kv: kv[0])
    return out


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw little-endian bytes of a tensor (copied to the host)."""
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return raw.cpu().numpy().tobytes()


def _entry(path: str, t: torch.Tensor, off: int) -> Dict[str, Any]:
    return {"path": path, "dtype": dtype_name(t.dtype), "shape": list(t.shape),
            "offset": off, "nbytes": t.numel() * t.element_size()}


def to_bytes(tree) -> Tuple[bytes, List[Dict[str, Any]]]:
    """-> (flat byte buffer, manifest)."""
    chunks, manifest, off = [], [], 0
    for path, t in flatten_with_paths(tree):
        manifest.append(_entry(path, t, off))
        chunks.append(tensor_bytes(t))
        off += manifest[-1]["nbytes"]
    return b"".join(chunks), manifest


def manifest_of(tree) -> List[Dict[str, Any]]:
    """The manifest :func:`to_bytes` would produce, without the byte buffer
    (layout is a function of shapes and dtypes only)."""
    manifest, off = [], 0
    for path, t in flatten_with_paths(tree):
        manifest.append(_entry(path, t, off))
        off += manifest[-1]["nbytes"]
    return manifest


def restructure(flat: Dict[str, torch.Tensor], like, prefix: tuple = ()):
    """``{path: tensor}`` -> the nested-dict structure of ``like``, each
    leaf cast to the dtype of ``like``'s leaf where it differs."""
    if isinstance(like, dict):
        return {k: restructure(flat, v, prefix + (k,)) for k, v in like.items()}
    t = flat[path_str(prefix)]
    dt = leaf_dtype(like)
    return t if t.dtype == dt else t.to(dt)


def from_bytes(buf: bytes, manifest: List[Dict[str, Any]], like=None,
               device: DeviceLike = None):
    """Rebuild ``{path: tensor}`` on ``device`` (``None``: the card); with a
    ``like`` tree, restructure into it."""
    dev = resolve_device(device)
    flat: Dict[str, torch.Tensor] = {}
    for ent in manifest:
        dt = torch_dtype(ent["dtype"])
        n = int(np.prod(ent["shape"]) or 1)
        raw = np.frombuffer(buf, np.uint8, count=n * dt.itemsize,
                            offset=ent["offset"])
        flat[ent["path"]] = torch.from_numpy(raw.copy()).view(dt).reshape(
            ent["shape"]).to(dev)
    return flat if like is None else restructure(flat, like)
