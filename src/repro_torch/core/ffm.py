"""Field-aware Factorization Machine primitives (port of ``repro/core/ffm.py``).

Each example carries one hashed feature index per field plus a float value.
FFM weights live in a single table ``W[hash_space, n_fields, k]`` where
``W[i, f]`` is the embedding of feature ``i`` used when interacting with
field ``f``. ``DiagMask``: only the strict upper triangle of the field x
field interaction matrix is kept.

Index bookkeeping (pair orders, tail gathers) stays numpy, as in the JAX
package; :func:`on_device` holds device copies of those constant index
vectors so the request path uploads each once per device.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.common.config import FFMConfig
from repro_torch.common.pspec import ParamSpec


def _dtype(cfg: FFMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def ffm_specs(cfg: FFMConfig) -> Dict[str, ParamSpec]:
    return {
        "emb": ParamSpec((cfg.hash_space, cfg.n_fields, cfg.k),
                         ("vocab", "null", "null"), "embed", _dtype(cfg)),
    }


def lr_specs(cfg: FFMConfig) -> Dict[str, ParamSpec]:
    return {
        "w": ParamSpec((cfg.hash_space,), ("vocab",), "zeros", _dtype(cfg)),
        "b": ParamSpec((), (), "zeros", _dtype(cfg)),
    }


def gather_rows(emb, idx: torch.Tensor) -> torch.Tensor:
    """Embedding row gather: ``emb`` is the f32 table ``(V, F, k)``, an
    int8 row-quantized table dict (``quantization.quantize_rows`` format),
    whose gathers go through ``kernels/row_gather`` (the gather-and-dequant
    kernel on the card), or a sharded fleet's assembled view (an object
    with ``gather_view``, ``serving.shard_router.ShardedRows``), which gathers
    per owning shard into disjoint output rows."""
    if hasattr(emb, "gather_view"):
        return emb.gather_view(idx)
    if isinstance(emb, dict):
        from repro_torch.kernels.row_gather import ops as rg_ops

        return rg_ops.gather_dequant_rows(emb, idx)
    return emb[idx]


def gather_lr(lr_w, idx: torch.Tensor) -> torch.Tensor:
    """LR weight lookup: f32 vector ``(V,)``, a blocked-int8 dict
    (``quantization.quantize_blocks`` format), dequantized per element, or
    a sharded fleet's assembled view (``serving.shard_router.ShardedLR``)."""
    if hasattr(lr_w, "gather_view"):
        return lr_w.gather_view(idx)
    if isinstance(lr_w, dict):
        c = lr_w["codes"][idx].to(torch.float32)
        b = torch.div(idx, lr_w["block"], rounding_mode="floor")
        return c * lr_w["scale"][b] + lr_w["zero"][b]
    return lr_w[idx]


def gather_rows_np(emb, idx: np.ndarray) -> np.ndarray:
    """Host-numpy :func:`gather_rows` over a host table: an f32 ``(V, F,
    k)`` array or an int8 row-quantized dict of arrays, dequantized by the
    packed host gather (``row_gather.ops.gather_dequant_np``)."""
    if isinstance(emb, dict):
        from repro_torch.kernels.row_gather import ops as rg_ops

        return rg_ops.gather_dequant_np(emb, idx)
    return np.asarray(emb)[idx]


def gather_lr_np(lr_w, idx: np.ndarray) -> np.ndarray:
    """Host-numpy :func:`gather_lr` over a host LR table (f32 ``(V,)`` or a
    blocked-int8 dict of arrays): the engine's host pre-gather sums the
    candidates' LR terms with it."""
    if isinstance(lr_w, dict):
        idx = np.asarray(idx)
        c = np.asarray(lr_w["codes"])[idx].astype(np.float32)
        b = idx // int(lr_w["block"])
        return c * np.asarray(lr_w["scale"])[b] + np.asarray(lr_w["zero"])[b]
    return np.asarray(lr_w)[idx]


def table_dtype(emb) -> torch.dtype:
    """Dtype of the *dequantized* rows ``gather_rows`` yields."""
    return torch.float32 if isinstance(emb, dict) else emb.dtype


def pair_indices(n_fields: int) -> Tuple[np.ndarray, np.ndarray]:
    """Upper-triangle (i<j) field pairs — the DiagMask."""
    iu = np.triu_indices(n_fields, k=1)
    return iu[0].astype(np.int32), iu[1].astype(np.int32)


def pair_split(cfg: FFMConfig):
    """Global DiagMask pair order split into ctx-ctx / ctx-cand / cand-cand
    positions into the canonical ``pair_indices`` order."""
    pi, pj = pair_indices(cfg.n_fields)
    fc = cfg.context_fields
    cc = np.flatnonzero((pi < fc) & (pj < fc))
    xc = np.flatnonzero((pi < fc) & (pj >= fc))
    aa = np.flatnonzero((pi >= fc) & (pj >= fc))
    return (pi, pj), cc, xc, aa


# A context of Fc fields decomposes over its *prefixes*: every cacheable term
# of the context partial is either per-field (embeddings, values, LR terms) or
# a pair (i, j) with i < j < Fc, which belongs to prefix length j+1. Ordering
# the ctx-ctx pairs j-major makes the pair vector of a depth-p prefix a
# contiguous slice of the full vector — so a cached prefix partial extends by
# appending, and a deeper partial slices down to any shallower depth.


def prefix_pair_count(p: int) -> int:
    """Number of ctx-ctx pairs among the first ``p`` context fields."""
    return p * (p - 1) // 2


def prefix_pair_order(fc: int) -> Tuple[np.ndarray, np.ndarray]:
    """j-major ctx-ctx pair order: for j in [1, fc), all (i, j) with i < j."""
    if fc < 2:
        z = np.zeros(0, np.int32)
        return z, z.copy()
    ii = np.concatenate([np.arange(j) for j in range(1, fc)])
    jj = np.concatenate([np.full(j, j) for j in range(1, fc)])
    return ii.astype(np.int32), jj.astype(np.int32)


def prefix_to_cc_perm(cfg: FFMConfig) -> np.ndarray:
    """Permutation from j-major prefix pair order to the global cc order:
    ``pairs_cc_global = pairs_prefix[prefix_to_cc_perm(cfg)]``."""
    (pi, pj), cc, _, _ = pair_split(cfg)
    ii, jj = prefix_pair_order(cfg.context_fields)
    pos = {(int(i), int(j)): t for t, (i, j) in enumerate(zip(ii, jj))}
    return np.asarray([pos[(int(pi[c]), int(pj[c]))] for c in cc], np.int32)


def tail_pair_gather(fc: int, p: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gather indices ``(ii, jt)`` for the pairs appended when extending
    depth p -> fc: the new j-major pairs are ``pair_matrix[ii, jt]`` where
    ``pair_matrix[i, jt]`` holds the (i, p+jt) interaction."""
    if fc - p < 1 or fc < 2:
        z = np.zeros(0, np.int32)
        return z, z.copy()
    ii = np.concatenate([np.arange(j) for j in range(p, fc)])
    jt = np.concatenate([np.full(j, j - p) for j in range(p, fc)])
    return ii.astype(np.int32), jt.astype(np.int32)


@lru_cache(maxsize=512)
def on_device(fn, args: tuple, device: torch.device):
    """Device copies (int64) of the constant index arrays ``fn(*args)``
    returns — an array or nested tuples of arrays — made once per
    ``(fn, args, device)``."""
    def conv(x):
        if isinstance(x, tuple):
            return tuple(conv(a) for a in x)
        return torch.from_numpy(np.asarray(x, np.int64)).to(device)

    return conv(fn(*args))


def empty_context_prefix(cfg: FFMConfig, dtype=torch.float32,
                         device=None) -> Dict[str, torch.Tensor]:
    """The depth-0 context prefix state (identity of ``extend_context_prefix``)."""
    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "emb": zeros(0, cfg.n_fields, cfg.k, dt=dtype),
        "val": zeros(0),
        "pairs": zeros(0),
        "lr_terms": zeros(0),
    }


def extend_context_prefix(cfg: FFMConfig, emb, lr_w,
                          prefix: Dict[str, torch.Tensor],
                          tail_idx: torch.Tensor, tail_val: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
    """Extend a depth-p context prefix state by ``t`` tail fields.

    ``prefix`` holds the per-prefix partial state (all in j-major order):

    * ``emb``      (p, F, k) — context features' embeddings for every field
    * ``val``      (p,)      — feature values
    * ``pairs``    (p(p-1)/2,) — ctx-ctx interactions among the prefix
    * ``lr_terms`` (p,)      — per-field LR contributions

    Only the tail's embeddings are gathered (through the row-gather kernel
    for int8 tables) and only pairs (i, j) with j >= p are computed. The
    result is the depth-(p+t) state, sliceable back to any depth <= p+t.
    """
    p = prefix["emb"].shape[0]
    fc = p + tail_idx.shape[0]
    te = gather_rows(emb, tail_idx)                           # (t, F, k)
    e = torch.cat([prefix["emb"], te], dim=0)                 # (p+t, F, k)
    tv = tail_val.to(torch.float32)
    v = torch.cat([prefix["val"], tv])
    # pair (i, j): dot(e[i, field j], e[j, field i]) * v_i * v_j
    dots = torch.einsum("itk,tik->it", e[:, p:fc], te[:, :fc])  # (p+t, t)
    pm = dots * (v[:, None] * v[None, p:])
    ii, jt = on_device(tail_pair_gather, (fc, p), pm.device)
    pairs = torch.cat([prefix["pairs"], pm[ii, jt].to(torch.float32)])
    lr_tail = (gather_lr(lr_w, tail_idx) * tv).to(torch.float32)
    lr_terms = torch.cat([prefix["lr_terms"], lr_tail])
    return {"emb": e, "val": v, "pairs": pairs, "lr_terms": lr_terms}


def fused_context_state(cfg: FFMConfig, emb, lr_w,
                        prefix: Dict[str, torch.Tensor],
                        tail_idx: torch.Tensor, tail_val: torch.Tensor
                        ) -> Dict[str, object]:
    """Gather-only context extension for the fused scoring path.

    Where :func:`extend_context_prefix` computes the tail pairs, the fused
    kernel computes them on the device from the full-depth rows — so
    context resolution only gathers the tail rows (through the row-gather
    kernel for int8 tables) and LR terms, carries the prefix's cached pair
    sum as a scalar and records the prefix depth, so the kernel knows which
    pairs are still owed. The state stacks into the fused kernel's per-row
    inputs:

    * ``emb``      (fc, F, k) f32 — full-depth context embeddings
    * ``val``      (fc,)
    * ``depth``    int          — cached prefix depth p (a host integer:
                                  stacking uploads the row vector at once,
                                  and reading it back never waits on the
                                  device)
    * ``pair_sum`` () f32       — sum of the prefix's cached ctx-ctx pairs
    * ``lr_terms`` (fc,)

    ``prefix["pairs"]`` is not re-emitted: only its sum enters the logit,
    and :func:`prefix_state_from_dots` rebuilds the full j-major vector from
    the kernel's returned pair matrix when the engine inserts the state.
    """
    p = prefix["emb"].shape[0]
    te = gather_rows(emb, tail_idx).to(torch.float32)
    tv = tail_val.to(torch.float32)
    lr_tail = (gather_lr(lr_w, tail_idx) * tv).to(torch.float32)
    return {
        "emb": torch.cat([prefix["emb"], te], dim=0),
        "val": torch.cat([prefix["val"], tv]),
        "depth": int(p),
        "pair_sum": torch.sum(prefix["pairs"]),
        "lr_terms": torch.cat([prefix["lr_terms"], lr_tail]),
    }


def prefix_state_from_dots(cfg: FFMConfig, fused: Dict[str, object],
                           prefix_pairs: torch.Tensor, dots: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
    """Rebuild a full-depth insertable prefix state from fused-kernel output.

    ``fused`` is a :func:`fused_context_state` state, ``prefix_pairs`` the
    j-major pair vector of its depth-p cached prefix, and ``dots`` the
    kernel's (fc, fc) ctx pair matrix (value products applied). The tail
    pairs are the j-major gather ``dots[ii, p + jt]`` — the same slots
    :func:`extend_context_prefix` computes — so the state has the staged
    path's format."""
    fc = fused["emb"].shape[0]
    p = int(fused["depth"])
    ii, jt = on_device(tail_pair_gather, (fc, p), dots.device)
    tail = dots.to(torch.float32)[ii, p + jt]
    return {
        "emb": fused["emb"],
        "val": fused["val"],
        "pairs": torch.cat([prefix_pairs.to(torch.float32), tail]),
        "lr_terms": fused["lr_terms"],
    }


def slice_context_prefix(state: Dict[str, torch.Tensor], depth: int
                         ) -> Dict[str, torch.Tensor]:
    """View of a prefix state at a shallower ``depth`` (pure slicing, by
    construction of the j-major pair order)."""
    return {
        "emb": state["emb"][:depth],
        "val": state["val"][:depth],
        "pairs": state["pairs"][: prefix_pair_count(depth)],
        "lr_terms": state["lr_terms"][:depth],
    }


def lookup(cfg: FFMConfig, emb, idx: torch.Tensor) -> torch.Tensor:
    """idx: (B, F) -> E: (B, F, F, k) with E[b, i, j] = emb[idx[b,i], j]."""
    return gather_rows(emb, idx)


def interactions(cfg: FFMConfig, emb, idx, val) -> torch.Tensor:
    """DiagMask'd pairwise FFM terms, (B, n_pairs) — the plain oracle;
    ``kernels/ffm_interaction/ops.interactions`` is the kernel path."""
    e = lookup(cfg, emb, idx)  # (B, F, F, k)
    dots = torch.einsum("bijk,bjik->bij", e, e)  # (B, F, F)
    vv = val[:, :, None] * val[:, None, :]
    pi, pj = on_device(pair_indices, (cfg.n_fields,), dots.device)
    return (dots * vv)[:, pi, pj]


def lr_forward(cfg: FFMConfig, p, idx, val) -> torch.Tensor:
    """Logistic-regression part: (B,). ``p["w"]`` may be a blocked-int8
    dict (:func:`gather_lr`)."""
    return torch.sum(gather_lr(p["w"], idx) * val, dim=-1) + p["b"]


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits; labels in {0, 1}. Spelled as the JAX
    package spells it (``max``, ``log1p``, ``exp``), with JAX's gradients
    at a logit of exactly 0 (a linear model's first step): ``torch.maximum``
    splits a tie as ``jnp.maximum`` does, and ``|x|`` is a ``where`` with
    slope 1 at 0, as ``jnp.abs`` (``torch.abs`` has slope 0 there)."""
    lf = logits.to(torch.float32)
    yl = labels.to(torch.float32)
    abs_lf = torch.where(lf >= 0, lf, -lf)
    return torch.mean(torch.maximum(lf, lf.new_zeros(())) - lf * yl
                      + torch.log1p(torch.exp(-abs_lf)))
