"""Logical-axis sharding rules, MaxText-style, and ZeRO-1 optimizer
sharding (port of ``repro/launch/sharding.py``).

Every parameter carries logical axis names (from its ``ParamSpec``); a rule
table maps logical axes to mesh axes, with replication where a dim does not
divide. Batches shard their batch dim over the data axes.

Param strategy:
  * ``model`` axis carries tensor parallelism: vocab, heads, mlp, experts...
  * ``fsdp=True`` configs additionally shard the ``embed`` axis over the
    data axes (weights gathered on use).
  * ``pure_dp`` configs replicate every parameter.
  * optimizer state is ZeRO-1 (:func:`zero1_shardings`): each state leaf
    additionally shards its largest still-unsharded dim over the data axes.

A spec is what JAX's ``PartitionSpec`` holds: per dim None, one mesh-axis
name, or a tuple of names. The rules read only the mesh's axis sizes, so
``mesh`` may be a ``DeviceMesh`` or a mapping of axis name to size (JAX's
``Mesh.shape``), which lets them run at a production mesh's shape without
a world. :func:`abstract_mesh` gives that mapping. :func:`shard_slices` turns
a spec into a rank's slice of the full leaf (JAX's ``devices_indices_map``),
:func:`gather` puts the leaf back together.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
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


def abstract_mesh(axis_sizes: Tuple[int, ...],
                  axis_names: Tuple[str, ...]) -> Dict[str, int]:
    """A mesh by its axis sizes alone (JAX's ``AbstractMesh``): the mapping
    of axis name to size that every rule here reads, with no world."""
    return dict(zip(axis_names, axis_sizes))


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


def map_tree(fn, *trees):
    """``fn`` over the leaves of nested dicts that share one structure."""
    if isinstance(trees[0], dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def param_shardings(cfg, specs_axes, abstract, mesh):
    """specs_axes: the logical-axes tree (``registry.param_axes``);
    abstract: a tree like it whose leaves have a ``shape`` (parameters or
    their ``ParamSpec``s). Returns the tree of specs."""
    rules = logical_rules(cfg, mesh)
    return map_tree(lambda axes, leaf: spec_for(tuple(leaf.shape), axes, rules,
                                            mesh), specs_axes, abstract)


def zero1_shardings(param_sharding_tree, abstract_tree, mesh):
    """Optimizer-state specs: each leaf's parameter spec plus, where no
    data axis is used yet, the data axes on its largest unsharded dim that
    divides (the first of equal dims, in JAX's ``argsort`` order); a leaf
    with none keeps its parameter spec."""
    sizes = _axis_sizes(mesh)
    data_axes = _data_axes(mesh)
    dsize = _axis_size(sizes, data_axes)

    def one(pspec, leaf):
        shape = tuple(leaf.shape)
        spec = list(pspec) + [None] * (len(shape) - len(pspec))
        used = {a for e in spec for a in _entry_axes(e)}
        if not (set(data_axes) & used):
            for i in np.argsort([-d for d in shape]):
                if spec[i] is None and shape[i] % dsize == 0:
                    spec[i] = data_axes if len(data_axes) > 1 else data_axes[0]
                    break
        return tuple(spec)

    return map_tree(one, param_sharding_tree, abstract_tree)


def batch_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """Shard dim 0 (global batch) over the data axes when divisible."""
    sizes = _axis_sizes(mesh)
    data_axes = _data_axes(mesh)
    if shape and shape[0] % _axis_size(sizes, data_axes) == 0:
        first = data_axes if len(data_axes) > 1 else data_axes[0]
        return (first,) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def batch_shardings(batch_abstract, mesh):
    return map_tree(lambda leaf: batch_spec(tuple(leaf.shape), mesh),
                batch_abstract)


def replicated(mesh) -> Spec:
    return ()


def decode_state_shardings(cfg, state_abstract, mesh):
    """Specs of the decode state, by leaf name, as the JAX package's rules.

    The port's state has JAX's leaf names (``k``, ``v``, ``cross_k``,
    ``cross_v``, ``k_scale``, ``v_scale``, ``ckv``, ``kr``, ``ssm``,
    ``conv``, under the same parents); only ``pos`` differs, a Python int
    where JAX holds a 0-d array, and its spec is ``()`` (replicated) as
    there. KV rings (..., B, S, K, D): batch over the data axes when
    divisible, else the sequence; kv-heads over "model" when divisible,
    else the sequence (flash-decode style). MLA latents (..., B, S, R):
    batch-else-sequence over data, then the sequence over "model". SSM
    states (..., B, H, N, P): batch over data, heads over "model". Conv
    states (..., B, K, C): batch over data, channels over "model"."""
    sizes = _axis_sizes(mesh)
    data_axes = _data_axes(mesh)
    dsize = _axis_size(sizes, data_axes)
    msize = sizes["model"]
    d_ax = data_axes if len(data_axes) > 1 else data_axes[0]

    def leaf(name, t):
        if name == "pos" or not hasattr(t, "shape"):
            return ()
        shape = tuple(t.shape)
        nd = len(shape)
        spec = [None] * nd
        if name in ("k", "v", "cross_k", "cross_v"):
            b, s, kh = nd - 4, nd - 3, nd - 2
            if shape[b] % dsize == 0:
                spec[b] = d_ax
            elif shape[s] % dsize == 0:
                spec[s] = d_ax
            if shape[kh] % msize == 0:
                spec[kh] = "model"
            elif spec[s] is None and shape[s] % msize == 0:
                spec[s] = "model"
        elif name in ("k_scale", "v_scale"):
            b, sq, kh = nd - 3, nd - 2, nd - 1
            if shape[b] % dsize == 0:
                spec[b] = d_ax
            if shape[kh] % msize == 0:
                spec[kh] = "model"
            elif shape[sq] % msize == 0:
                spec[sq] = "model"
        elif name in ("ckv", "kr"):
            b, s = nd - 3, nd - 2
            if shape[b] % dsize == 0:
                spec[b] = d_ax
            elif shape[s] % dsize == 0:
                spec[s] = d_ax
            if spec[s] is None and shape[s] % msize == 0:
                spec[s] = "model"
        elif name == "ssm":
            b, h = nd - 4, nd - 3
            if shape[b] % dsize == 0:
                spec[b] = d_ax
            if shape[h] % msize == 0:
                spec[h] = "model"
        elif name == "conv":
            b, c = nd - 3, nd - 1
            if shape[b] % dsize == 0:
                spec[b] = d_ax
            if shape[c] % msize == 0:
                spec[c] = "model"
        return tuple(spec)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in tree.items()}

    return walk(state_abstract)


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
    return map_tree(lambda t, s: local_shard(t, s, rt).clone(), tree, specs)


def gather_tree(tree, specs, rt: runtime.Runtime):
    """Each leaf gathered whole (a collective)."""
    return map_tree(lambda t, s: gather(t, s, rt), tree, specs)
