"""Distribution runtime context threaded through model forwards (port of
``repro/common/runtime.py``), and the collectives its users call.

The JAX package's model code sees global arrays and lets GSPMD place them.
The port is SPMD by hand: under a :class:`Runtime` with a mesh, the model
code runs on every rank of the mesh, each rank on its rows of the batch
(``launch/sharding.py:batch_spec``) with full weights, and every number
that crosses ranks goes through one of the collectives below, each named
after the ``jax.lax`` primitive it stands for (``psum``, ``all_gather``,
``all_to_all``, ``axis_index``).

Each collective is differentiable with its exact adjoint: ``psum``'s
backward is a ``psum``, ``all_to_all``'s an ``all_to_all`` back, and
``all_gather``'s the sum of the gathered gradients, scattered back to the
ranks that gave the pieces. That sum is right because every rank
differentiates its share of the loss (``train/steps.py``): ranks that hold
the same rows divide their loss by their count, so the gradients of all
ranks sum to the global gradient. (A gather whose backward summed the
gradients of undivided copies would give ``n_model`` times too much.)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# torch 2.13 renamed the tensor forms of the two collectives; older builds
# have only the old names
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


@dataclass(frozen=True)
class Runtime:
    """Mesh + axis naming. ``None`` mesh means single-device execution.

    ``mesh`` is a ``torch.distributed`` ``DeviceMesh``; ``groups`` maps
    each tuple of axes a collective may span to its process group
    (``launch/mesh.py:make_runtime`` builds both). ``batch_split`` says
    whether the activations a rank holds are its slice of the batch over
    ``data_axes`` (True, ``batch_spec``'s split) or the whole batch (False,
    its fallback for a batch that does not divide); the sharded train step
    sets it per batch."""

    mesh: Optional[Any] = None
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    batch_split: bool = True
    groups: Dict[Tuple[str, ...], Any] = field(
        default_factory=dict, compare=False, repr=False)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return self.data_axes + (self.model_axis,)

    @property
    def n_devices(self) -> int:
        return self.mesh.size() if self.mesh is not None else 1

    def axis_size(self, axes: Sequence[str]) -> int:
        names = self.mesh.mesh_dim_names
        n = 1
        for a in axes:
            n *= self.mesh.size(names.index(a))
        return n

    def axis_index(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes``, row-major in their order (what
        ``jax.lax.axis_index`` gives for a tuple of axes)."""
        names = self.mesh.mesh_dim_names
        coord = self.mesh.get_coordinate()
        idx = 0
        for a in axes:
            i = names.index(a)
            idx = idx * self.mesh.size(i) + coord[i]
        return idx

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only
        along ``axes``, ranked row-major in their order."""
        axes = tuple(axes)
        if axes not in self.groups:
            raise KeyError(f"no process group for axes {axes}; build the "
                           "Runtime with launch.mesh.make_runtime")
        return self.groups[axes]

    def seq_shard(self, x, cfg):
        """The JAX package's Megatron-SP sharding constraint on the
        layer-boundary residual stream. A constraint changes no number; no
        config sets ``seq_shard_acts``, so under a mesh the port refuses
        it."""
        if cfg.seq_shard_acts and self.mesh is not None:
            raise NotImplementedError(
                "seq_shard_acts (the residual stream's sequence sharded over "
                "the model axis) is not ported: no config sets it "
                "(ROADMAP.md Queue 1 item 10)")
        return x


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x.contiguous(), group=group)
    return out


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's pieces of ``x`` concatenated along ``dim`` in group-rank
    order (not differentiable; :func:`all_gather` is). The pieces arrive
    one after another, as if stacked on a new leading dim; the reshape
    copies them once more only where they must interleave (``dim`` > 0 on
    more than one rank)."""
    n = dist.get_world_size(group)
    stacked = _gather0(x, group).view((n,) + tuple(x.shape))
    shape = list(x.shape)
    shape[dim] *= n
    return stacked.movedim(0, dim).reshape(shape)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        _REDUCE_SCATTER(out, g.contiguous(), group=ctx.group)
        return out, None


def _all_to_all0(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all0(g, ctx.group), None


def psum(x: torch.Tensor, rt: Runtime, axes: Sequence[str]) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axes`` (``jax.lax.psum``)."""
    return _Psum.apply(x, rt.group(axes))


def all_gather(x: torch.Tensor, rt: Runtime,
               axes: Sequence[str]) -> torch.Tensor:
    """The ranks' ``x`` along ``axes`` concatenated on dim 0 in their
    row-major order (``jax.lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, rt.group(axes))


def all_to_all(x: torch.Tensor, rt: Runtime, axis: str) -> torch.Tensor:
    """Dim 0 of ``x`` split into one chunk per rank along ``axis``; chunk j
    goes to rank j, and what arrives is concatenated on dim 0 in source
    order (``jax.lax.all_to_all(x, axis, 0, 0)``)."""
    return _AllToAll.apply(x, rt.group((axis,)))
