"""Logical-axis sharding rules, MaxText-style (port of
``repro/launch/sharding.py``'s rules, parameter and batch shardings).

Every parameter carries logical axis names (from its ``ParamSpec``); a rule
table maps logical axes to mesh axes, with replication where a dim does not
divide. Batches shard their batch dim over the data axes.

Param strategy:
  * ``model`` axis carries tensor parallelism: vocab, heads, mlp, experts...
  * ``fsdp=True`` configs additionally shard the ``embed`` axis over the
    data axes (weights gathered on use).
  * ``pure_dp`` configs replicate every parameter.

A spec is what JAX's ``PartitionSpec`` holds: per dim None, one mesh-axis
name, or a tuple of names. The rules read only the mesh's axis sizes, so
``mesh`` may be a ``DeviceMesh`` or a mapping of axis name to size (JAX's
``Mesh.shape``), which lets them run at a production mesh's shape without
a world. :func:`shard_slices` turns a spec into a rank's slice of the full
leaf (JAX's ``devices_indices_map``), :func:`gather` puts the leaf back
together. ZeRO-1 optimizer shardings and the decode state's wait for the
dry run (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.common import runtime

Spec = Tuple  # per dim: None, an axis name, or a tuple of axis names


def _axis_sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(n for n in _axis_sizes(mesh) if n != "model")


def logical_rules(cfg, mesh) -> Dict[str, Optional[Tuple[str, ...]]]:
    data_axes = _data_axes(mesh)
    if getattr(cfg, "pure_dp", False):
        # small-model strategy: no tensor parallelism; every param
        # replicated, batch over the data axes
        return {k: None for k in (
            "vocab", "embed", "mlp", "heads", "kv_heads", "head_dim",
            "experts", "expert_mlp", "kv_lora", "q_lora", "ssm_inner",
            "ssm_state", "ssm_heads", "conv", "layers", "stack", "null")}
    return {
        "vocab": ("model",),
        "embed": data_axes if cfg.fsdp else None,
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": None,
        "experts": ("model",),
        "expert_mlp": None,  # experts already own the model axis
        "kv_lora": None,
        "q_lora": None,
        "ssm_inner": ("model",),
        "ssm_state": None,
        "ssm_heads": None,
        "conv": None,
        "layers": None,
        "stack": None,
        "null": None,
    }


def _axis_size(sizes: Dict[str, int], axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes: () for None."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_for(shape: Tuple[int, ...], logical: Tuple[str, ...], rules,
             mesh) -> Spec:
    """Map one param's logical axes to a spec with divisibility checks."""
    sizes = _axis_sizes(mesh)
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        mapped = rules.get(name)
        if (mapped and not (set(mapped) & used)
                and dim % _axis_size(sizes, mapped) == 0):
            parts.append(mapped if len(mapped) > 1 else mapped[0])
            used.update(mapped)
        else:
            parts.append(None)
    return tuple(parts)


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts that share one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def param_shardings(cfg, specs_axes, abstract, mesh):
    """specs_axes: the logical-axes tree (``registry.param_axes``);
    abstract: a tree like it whose leaves have a ``shape`` (parameters or
    their ``ParamSpec``s). Returns the tree of specs."""
    rules = logical_rules(cfg, mesh)
    return _map(lambda axes, leaf: spec_for(tuple(leaf.shape), axes, rules,
                                            mesh), specs_axes, abstract)


def batch_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """Shard dim 0 (global batch) over the data axes when divisible."""
    sizes = _axis_sizes(mesh)
    data_axes = _data_axes(mesh)
    if shape and shape[0] % _axis_size(sizes, data_axes) == 0:
        first = data_axes if len(data_axes) > 1 else data_axes[0]
        return (first,) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def batch_shardings(batch_abstract, mesh):
    return _map(lambda leaf: batch_spec(tuple(leaf.shape), mesh),
                batch_abstract)


def replicated(mesh) -> Spec:
    return ()


# ---------------------------------------------------------------------------
# A rank's slice of a leaf, and the leaf put back together
# ---------------------------------------------------------------------------

def shard_slices(shape: Tuple[int, ...], spec: Spec, rt: runtime.Runtime,
                 keep: Tuple[str, ...] = ()) -> Tuple[slice, ...]:
    """This rank's slice of a leaf of ``shape`` under ``spec``: each dim
    split evenly over its axes, the rank's block at its row-major index
    along them. Axes in ``keep`` are left out (the leaf stays whole along
    them)."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = tuple(a for a in _entry_axes(entry) if a not in keep)
        if not axes:
            out.append(slice(None))
            continue
        chunk = n // rt.axis_size(axes)
        start = rt.axis_index(axes) * chunk
        out.append(slice(start, start + chunk))
    return tuple(out)


def local_shard(full: torch.Tensor, spec: Spec, rt: runtime.Runtime,
                keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """The rank's slice of ``full`` (a view)."""
    return full[shard_slices(tuple(full.shape), spec, rt, keep)]


def gather(shard: torch.Tensor, spec: Spec, rt: runtime.Runtime,
           keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """The inverse of :func:`local_shard` (a collective: every rank along
    the spec's axes calls it): the ranks' slices concatenated dim by dim,
    all axes but those in ``keep``."""
    out = shard
    for i, entry in enumerate(spec):
        axes = tuple(a for a in _entry_axes(entry) if a not in keep)
        if axes:
            out = runtime.gather_dim(out, i, rt.group(axes))
    return out


def local_tree(tree, specs, rt: runtime.Runtime):
    """Each leaf's slice for this rank, in fresh memory."""
    return _map(lambda t, s: local_shard(t, s, rt).clone(), tree, specs)


def gather_tree(tree, specs, rt: runtime.Runtime):
    """Each leaf gathered whole (a collective)."""
    return _map(lambda t, s: gather(t, s, rt), tree, specs)
