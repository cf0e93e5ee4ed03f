"""Meshes and the process world (port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over an initialized world,
row-major like the JAX package's ``np.asarray(devices[:n]).reshape(...)``:
rank r of an (n_data, n_model) mesh sits at (r // n_model, r % n_model).
:func:`world` starts and ends the world (NCCL on the card, gloo on the
CPU, a ``FileStore`` under a temporary directory, no TCP port);
:func:`spawn` runs a function in n gloo ranks on the CPU, the counterpart
of XLA's forced host device count. :func:`fake_world` makes this process
rank 0 of a world of any size whose collectives return at once (the fake
backend): the dry run (``launch/dryrun_lib.py``) builds the production
mesh (:func:`make_production_mesh`, 16 x 16 or 2 x 16 x 16) in it and runs
a rank's step on meta tensors. One process holds one default group, so a
fake world cannot open inside another world: the dry run runs in a
process of its own, as the JAX package's does.

    with world("cpu"):                       # one rank
        rt = make_runtime(make_smoke_mesh(1, 1))
    with fake_world(256):
        rt = make_runtime(make_production_mesh())
"""
from __future__ import annotations

import contextlib
import math
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.runtime import Runtime


@contextlib.contextmanager
def world(device: DeviceLike = None, n_ranks: int = 1, rank: int = 0,
          store_path: Optional[str] = None):
    """This process as rank ``rank`` of an ``n_ranks`` world for the body
    of the ``with``; destroyed after it. NCCL on the card (rank r on card r
    mod the count; a failed init raises, nothing falls back to gloo or the
    CPU), gloo on the CPU. The ranks meet through a ``FileStore`` at
    ``store_path``, a file that does not yet exist, which every rank must
    be given; one rank may leave it out (a temporary directory holds it)."""
    dev = resolve_device(device)
    tmp = None
    if store_path is None:
        if n_ranks != 1:
            raise ValueError(f"{n_ranks} ranks must share one store_path")
        tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
        store_path = os.path.join(tmp, "store")
    kw = {}
    if dev.type == "cuda":
        index = rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
    try:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(store_path, n_ranks), rank=rank,
            world_size=n_ranks, **kw)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, n_ranks: int, store_path: str, fn, args) -> None:
    with world("cpu", n_ranks, rank, store_path):
        fn(rank, *args)


def spawn(fn, n_ranks: int, *args) -> None:
    """``fn(rank, *args)`` in ``n_ranks`` spawned processes, each a rank of
    one gloo :func:`world`; returns when all have ended and raises if one
    failed (the others are stopped). ``fn`` and ``args`` must pickle."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(n_ranks, os.path.join(tmp, "store"), fn, args),
            nprocs=n_ranks, start_method="spawn")


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """This process as rank 0 of an ``n_ranks`` world on the fake backend
    (``torch.testing._internal.distributed.fake_pg``: every collective
    returns at once and leaves its output as it was, so on meta tensors it
    costs nothing) for the body of the ``with``; destroyed after it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the world's
    first ranks, row-major (the world must hold as many)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"need {n} ranks, have {have}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """One pod: a 16 x 16 ("data", "model") mesh of 256 ranks; two pods: 2
    x 16 x 16 ("pod", "data", "model"), 512, the "pod" axis a data axis.
    Raises when the world is smaller (:func:`fake_world` gives one of any
    size)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_smoke_mesh(n_data: int = 2, n_model: int = 2):
    """An (n_data, n_model) mesh with axes ("data", "model") over the
    world's first n_data * n_model ranks (the world must hold as many)."""
    return make_mesh((n_data, n_model), ("data", "model"))


def _groups(mesh, axes_list):
    """One process group per tuple of axes: for each setting of the other
    axes, the ranks along these (every rank of the world creates every
    group, in one order, as ``new_group`` requires)."""
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh
    me = dist.get_rank()
    out = {}
    for axes in axes_list:
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {axes} out of the mesh's order {names}")
        rest = [i for i in range(len(names)) if i not in dims]
        size = math.prod(ranks.shape[i] for i in dims)
        for row in ranks.permute(rest + dims).reshape(-1, size).tolist():
            group = dist.new_group(row)
            if me in row:
                out[tuple(axes)] = group
    return out


def make_runtime(mesh) -> Runtime:
    """The mesh's :class:`Runtime`: every axis but "model" is a data axis;
    the process groups of each axis, of the data axes and of all axes."""
    if mesh is None:
        return Runtime(mesh=None)
    names = tuple(mesh.mesh_dim_names)
    data_axes = tuple(n for n in names if n != "model")
    axes_list = {(n,) for n in names} | {data_axes, data_axes + ("model",)}
    return Runtime(mesh=mesh, data_axes=data_axes, model_axis="model",
                   groups=_groups(mesh, sorted(axes_list)))
