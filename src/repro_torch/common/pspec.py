"""Declarative parameter specs (port of ``repro/common/pspec.py``).

Each model declares its parameters once as a nested dict of
:class:`ParamSpec`; :func:`materialize` turns the tree into tensors on a
device, drawing from one seeded ``torch.Generator``. The numbers differ from
the JAX package's (another generator); parity tests therefore hand the same
numpy weights to both packages (``repro_torch.convert``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]  # logical axis per dim; "null" = never sharded
    init: str = "normal"  # normal | zeros | ones | embed | scaled | uniform_conv
    dtype: Any = torch.bfloat16
    fan_in: int = 0  # for "scaled" init; 0 -> shape[-2] if ndim>=2 else shape[-1]

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _fan_in(spec: ParamSpec) -> int:
    shape = spec.shape
    return spec.fan_in or (shape[-2] if len(shape) >= 2 else shape[-1])


def _init_tensor(spec: ParamSpec, gen: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    shape, dtype = spec.shape, spec.dtype
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)

    def normal():
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    if spec.init == "scaled":
        return (normal() / np.sqrt(max(_fan_in(spec), 1))).to(dtype)
    if spec.init == "uniform_conv":
        lim = 1.0 / np.sqrt(max(shape[-1], 1))
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        return (u * (2 * lim) - lim).to(dtype)
    # "embed" and the default: normal(0, 0.02)
    return (normal() * 0.02).to(dtype)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string (``"bfloat16"`` / ``"float32"``) as a torch
    dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def count(specs) -> int:
    """Number of parameters in a spec tree (no memory is allocated)."""
    if is_spec(specs):
        return int(np.prod(specs.shape))
    return sum(count(v) for v in specs.values())


def abstract(specs):
    """The spec tree as empty meta tensors: each leaf's shape and dtype, no
    memory (the counterpart of the JAX package's ``ShapeDtypeStruct``
    tree)."""
    if is_spec(specs):
        return torch.empty(specs.shape, dtype=specs.dtype, device="meta")
    return {k: abstract(v) for k, v in specs.items()}


def axes(specs):
    """Logical-axes tree, same structure as the params (consumed by
    ``repro_torch.launch.sharding``)."""
    if is_spec(specs):
        return specs.axes
    return {k: axes(v) for k, v in specs.items()}


def stack(specs, n: int, axis_name: str = "layers"):
    """Prepend a stacking dim (the layers' parameter stacks). ``fan_in`` is
    kept: a stacked spec's ``shape[-2]`` is no longer its fan-in where the
    spec set one (``gqa_specs``'s ``wq`` / ``wk`` / ``wv``)."""
    if is_spec(specs):
        return ParamSpec((n,) + specs.shape, (axis_name,) + specs.axes,
                         specs.init, specs.dtype, specs.fan_in)
    return {k: stack(v, n, axis_name) for k, v in specs.items()}


def materialize(specs, seed: int = 0, device: DeviceLike = None):
    """Initialize real parameter tensors from the spec tree on ``device``.

    Leaves draw in sorted-key order from one generator seeded with
    ``seed``, so a tree is reproducible per (seed, device type). A leaf
    stacked over layers (:func:`stack`) draws one layer at a time into its
    final dtype, so its f32 draw never needs the whole stack's room (a
    chameleon-34b FFN stack is 8.7 G weights)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def walk(node):
        if not is_spec(node):
            return {k: walk(node[k]) for k in sorted(node)}
        if node.axes[:1] != ("layers",):
            return _init_tensor(node, gen, dev)
        one = ParamSpec(node.shape[1:], node.axes[1:], node.init, node.dtype,
                        _fan_in(node))
        out = torch.empty(node.shape, dtype=node.dtype, device=dev)
        for i in range(node.shape[0]):
            out[i] = _init_tensor(one, gen, dev)
        return out

    return walk(specs)

