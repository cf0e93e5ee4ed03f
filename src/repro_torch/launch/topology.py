"""Hash-space shard topology for the sharded serving tier (port of
``repro/launch/topology.py``; paper §2/§6).

Given a model config and a shard count it decides **which parameter rows
live on which shard**, and slices a params tree accordingly; the scoring
half lives in :mod:`repro_torch.serving.shard_router`. A leaf is
*row-sharded* when its :class:`~repro_torch.common.pspec.ParamSpec`'s
leading logical axis is ``vocab`` (the hashed feature tables) and
*replicated* otherwise (LR bias, MergeNorm, MLP head). The hash space
splits into **contiguous ranges**, so a shard's rows are a slice of every
full-space artifact: the f32 table, the int8 row-quantized table and the
serialized transfer buffer (which makes per-shard delta framing in
:class:`repro_torch.checkpoint.transfer.ShardedSender` a byte-range
intersection).

Shard boundaries are aligned to :data:`repro_torch.core.quantization.LR_BLOCK`,
so a shard's blocked-int8 LR grids are exactly the corresponding slice of
the full-space grids, and ``quantize(shard_slice(w)) ==
shard_slice(quantize(w))`` byte for byte. On one card a shard is still a
disjoint hash-space slice whose tables live in device memory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import layout
from repro_torch.common import pspec
from repro_torch.core import deepffm, quantization as Q

# leading logical axes that make a parameter row-sharded across the shards
ROW_SHARD_AXES = ("vocab",)


def row_sharded_paths(cfg, model: str = "deepffm") -> Tuple[str, ...]:
    """Manifest paths (``layout.path_str`` keys) of the row-sharded leaves,
    derived from the model's ParamSpecs: for DeepFFM ``ffm/emb`` (axes
    ``("vocab", "null", "null")``) and ``lr/w`` (``("vocab",)``)."""
    specs = deepffm.param_specs(cfg, model)
    return tuple(sorted(
        layout.path_str(path) for path, spec in layout.leaves(specs)
        if pspec.is_spec(spec) and spec.shape
        and spec.axes[0] in ROW_SHARD_AXES))


def shard_ranges(n_rows: int, n_shards: int) -> List[Tuple[int, int]]:
    """Split ``[0, n_rows)`` into ``n_shards`` contiguous ranges with
    boundaries aligned to ``LR_BLOCK``; as equal as alignment allows,
    earlier shards take the remainder. Every row is owned by exactly one
    shard."""
    align = Q.LR_BLOCK
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    units = -(-n_rows // align)
    if n_shards > units:
        raise ValueError(
            f"{n_shards} shards over {n_rows} rows need boundaries finer "
            f"than the {align}-row alignment (only {units} units)")
    per, extra = divmod(units, n_shards)
    ranges, lo = [], 0
    for s in range(n_shards):
        hi = lo + (per + (1 if s < extra else 0)) * align
        ranges.append((lo, min(hi, n_rows)))
        lo = hi
    ranges[-1] = (ranges[-1][0], n_rows)
    return ranges


def owner_of(ranges: Sequence[Tuple[int, int]], idx) -> np.ndarray:
    """Owning shard per hashed row index (one ``searchsorted`` against the
    upper boundaries)."""
    bounds = np.asarray([hi for _, hi in ranges[:-1]], np.int64)
    return np.searchsorted(bounds, np.asarray(idx), side="right")


def _slice_rows(leaf, lo: int, hi: int):
    """Row slice of one row-sharded leaf: an f32 tensor, an int8
    row-quantized dict or a blocked-int8 dict (block-aligned boundaries).
    Slices are views: a shard shares the full tree's memory."""
    if Q.is_block_quantized(leaf):
        block = int(leaf["block"])
        if lo % block:
            raise ValueError(
                f"shard boundary {lo} not aligned to LR block {block}")
        return {"codes": leaf["codes"][lo:hi],
                "scale": leaf["scale"][lo // block: -(-hi // block)],
                "zero": leaf["zero"][lo // block: -(-hi // block)],
                "block": block}
    if Q.is_row_quantized(leaf):
        return {"codes": leaf["codes"][lo:hi], "scale": leaf["scale"][lo:hi],
                "zero": leaf["zero"][lo:hi]}
    return leaf[lo:hi]


@dataclass(frozen=True)
class ShardTopology:
    """One fleet's row-ownership map: contiguous hash-space ranges, the
    row-sharded leaf paths and the replication factor (every slice is
    served by ``replicas`` engines holding byte-identical tables). Frozen:
    the trainer's frame slicing and the router's routing must agree on
    it."""

    cfg: Any
    model: str
    ranges: Tuple[Tuple[int, int], ...]
    row_paths: Tuple[str, ...]
    replicas: int = 1

    @classmethod
    def build(cls, cfg, model: str = "deepffm", n_shards: int = 1,
              replicas: int = 1) -> "ShardTopology":
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        return cls(cfg, model,
                   tuple(shard_ranges(cfg.hash_space, n_shards)),
                   row_sharded_paths(cfg, model), int(replicas))

    @property
    def n_shards(self) -> int:
        return len(self.ranges)

    def owner_of(self, idx) -> np.ndarray:
        return owner_of(self.ranges, idx)

    def shard_cfg(self, shard: int):
        """The shard-local config: the hash space shrunk to the owned range
        (every per-shard table is indexed by local rows)."""
        lo, hi = self.ranges[shard]
        return self.cfg.replace(hash_space=hi - lo)

    def shard_params(self, params, shard: int):
        """Slice a full-space params tree down to one shard: row-sharded
        leaves keep rows ``[lo, hi)``, replicated leaves are shared."""
        lo, hi = self.ranges[shard]

        def walk(node, prefix):
            if isinstance(node, dict) and not (
                    Q.is_row_quantized(node) or Q.is_block_quantized(node)):
                return {k: walk(v, prefix + (k,)) for k, v in node.items()}
            if "/".join(prefix) in self.row_paths:
                return _slice_rows(node, lo, hi)
            return node

        return walk(params, ())
