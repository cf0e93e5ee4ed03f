"""Rank bodies of the port's mesh tests (``tests/test_torch_sharding.py``,
``test_torch_mesh_moe.py``, ``test_torch_mesh_train.py``).

Each test file spawns one gloo world (``launch.mesh.spawn``) in a
module-scoped fixture; every rank runs one function below over all of the
file's cases and writes what it computed to ``rank<r>.npz``, and the
parametrized tests compare those arrays with the JAX package's. This module
imports torch and the port only, so a rank starts without JAX.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import moe, registry
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.steps import (loss_and_grads, make_train_step,
                                     sharded_loss_and_grads, zero1_specs)


def flatten(tree, prefix=""):
    """Nested dicts -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def load_tree(path, prefix=""):
    """The leaves of an npz under ``prefix``, as a nested dict of CPU
    tensors."""
    with np.load(path) as z:
        flat = {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix)}
    return convert.params_from_numpy(unflatten(flat), "cpu")


def _save(out_dir, rank, arrays):
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)


def _tensor_np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# test_torch_sharding.py: every leaf's local shard on a 2 x 2 mesh
# ---------------------------------------------------------------------------

def shard_config(arch: str, fsdp: bool):
    cfg = registry.get_config(arch, smoke=True)
    return cfg.replace(fsdp=True) if fsdp else cfg


def shards_rank(rank, out_dir, cases, batch_shapes):
    """For each case (name, arch, fsdp): every leaf as ``arange`` (values
    name their positions), this rank's ``local_shard`` of it, and whether
    ``gather`` of the shard gives the leaf back; the batch's local rows
    under ``batch_spec`` likewise."""
    torch.set_num_threads(1)
    rt = mesh_lib.make_runtime(mesh_lib.make_smoke_mesh(2, 2))
    out = {}
    for name, arch, fsdp in cases:
        cfg = shard_config(arch, fsdp)
        shapes = registry.param_specs(cfg)
        specs = sharding.param_shardings(cfg, registry.param_axes(cfg),
                                         shapes, rt.mesh)
        for path, spec in flatten(specs).items():
            shape = flatten(shapes)[path].shape
            full = torch.arange(int(np.prod(shape))).reshape(shape)
            mine = sharding.local_shard(full, spec, rt)
            out[f"{name}|{path}"] = mine.numpy()
            back = sharding.gather(mine.clone(), spec, rt)
            out[f"gather|{name}|{path}"] = np.asarray(torch.equal(back,
                                                                  full))
    for shape in batch_shapes:
        full = torch.arange(int(np.prod(shape))).reshape(shape)
        spec = sharding.batch_spec(shape, rt.mesh)
        out[f"batch|{shape}"] = sharding.local_shard(full, spec, rt).numpy()
    _save(out_dir, rank, out)


# ---------------------------------------------------------------------------
# test_torch_mesh_moe.py: the expert-parallel MoE on a 2 x 4 mesh
# ---------------------------------------------------------------------------

def moe_rank(rank, in_path, out_dir, cases):
    """For each case (name, layout, capacity factor): ``moe_expert_parallel``
    on this rank's rows of x (``layout`` "split": its data rows and the
    experts' model-axis slices; "whole": all of x and whole expert leaves,
    as when the batch does not divide). Writes y for the rank's rows and
    aux."""
    torch.set_num_threads(1)
    rt = mesh_lib.make_runtime(mesh_lib.make_smoke_mesh(2, 4))
    with np.load(in_path) as z:
        x = torch.from_numpy(z["x"])
    p = load_tree(in_path, "p/")
    base = registry.get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    out = {}
    for name, layout, cf in cases:
        cfg = base.replace(capacity_factor=cf)
        split = layout == "split"
        crt = dataclasses.replace(rt, batch_split=split)
        rows = x.shape[0] // rt.axis_size(rt.data_axes)
        first = rt.axis_index(rt.data_axes) * rows
        xr = x[first:first + rows] if split else x
        pr = dict(p)
        if split:  # the rank's experts only
            e_l = cfg.n_experts // rt.axis_size(("model",))
            m = rt.axis_index(("model",))
            for k in moe.EXPERT_LEAVES:
                pr[k] = p[k][m * e_l:(m + 1) * e_l].clone()
        y, aux = moe.moe_expert_parallel(cfg, pr, xr, crt)
        out[f"{name}|y"] = _tensor_np(y)
        out[f"{name}|aux"] = _tensor_np(aux)
        out[f"{name}|first"] = np.asarray(first if split else 0)
    _save(out_dir, rank, out)


# ---------------------------------------------------------------------------
# test_torch_mesh_train.py: the sharded train step on a 2 x 2 mesh
# ---------------------------------------------------------------------------

def _shard(cfg, tree, rt):
    specs = sharding.param_shardings(cfg, registry.param_axes(cfg), tree,
                                     rt.mesh)
    return sharding.local_tree(tree, specs, rt), specs


ABORT = "ABORT"  # written beside the inputs when their JAX side failed


def _wait_for(path, timeout=300.0):
    """The test process writes a case's inputs (``os.replace``, so whole)
    when its JAX reference is done; the ranks start on the cases ready."""
    end = time.monotonic() + timeout
    abort = os.path.join(os.path.dirname(path), ABORT)
    while not os.path.exists(path):
        if os.path.exists(abort) or time.monotonic() > end:
            raise RuntimeError(f"no inputs at {path}")
        time.sleep(0.05)


def _self_case(name, cfg, rt):
    """The sharded step's loss, metrics and gathered gradients beside the
    unsharded ``loss_and_grads`` on the same seeded weights and batch
    (``ref|`` keys); an MoE at capacity factor 8, where no copy drops and
    the expert-parallel path equals the dense one."""
    if cfg.is_moe:
        cfg = cfg.replace(capacity_factor=8.0)
    params = registry.init_params(cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             next(lm_batches(cfg.vocab_size, 4, 16, 1, seed=3)).items()}
    batch["labels"][0, :3] = -1
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (4, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    specs = sharding.param_shardings(cfg, registry.param_axes(cfg), params,
                                     rt.mesh)
    loss, metrics, grads = sharded_loss_and_grads(
        cfg, sharding.local_tree(params, specs, rt), batch, rt)
    ref_loss, ref_metrics, ref_grads = loss_and_grads(cfg, params, batch)
    out = {}
    for pre, l_, m, g in (("", loss, metrics, sharding.gather_tree(
            grads, specs, rt)), ("ref|", ref_loss, ref_metrics, ref_grads)):
        out.update({f"{name}|{pre}{k}": _tensor_np(v)
                    for k, v in {"loss": l_, **m}.items()})
        out.update({f"{name}|{pre}g|{k}": _tensor_np(v)
                    for k, v in flatten(g).items()})
    return out


def train_cases(rt, in_dir, cases):
    """Every case on this rank. ``cases``: (name, arch, moe_impl, kind)
    with the inputs in ``in_dir/<name>.npz`` (``b/`` the batch; ``grads``:
    ``p/`` the params; ``steps``: ``p<i>/`` and ``s<i>/`` each step's
    params and Adam state), waited for. ``grads`` gives the global metrics
    and every leaf's gathered gradient; ``steps`` each step's metrics from
    the given state; ``self`` (no inputs) :func:`_self_case`."""
    out = {}
    for name, arch, impl, kind in cases:
        cfg = registry.get_config(arch, smoke=True).replace(moe_impl=impl)
        if kind == "self":
            out.update(_self_case(name, cfg, rt))
            continue
        path = os.path.join(in_dir, f"{name}.npz")
        _wait_for(path)
        batch = load_tree(path, "b/")
        if kind == "grads":
            params, specs = _shard(cfg, load_tree(path, "p/"), rt)
            loss, metrics, grads = sharded_loss_and_grads(cfg, params, batch,
                                                          rt)
            whole = sharding.gather_tree(grads, specs, rt)
            out.update({f"{name}|g|{k}": _tensor_np(v)
                        for k, v in flatten(whole).items()})
            metrics = {"loss": loss, **metrics}
            out.update({f"{name}|{k}": _tensor_np(v)
                        for k, v in metrics.items()})
            continue
        opt = make_optimizer("adam", lr=1e-3)
        step_fn = make_train_step(cfg, opt, rt)
        with np.load(path) as z:
            n_steps = int(z["n_steps"])
        for i in range(n_steps):
            params, specs = _shard(cfg, load_tree(path, f"p{i}/"), rt)
            z1 = zero1_specs(cfg, rt)  # the state in ZeRO-1 slices
            state = {k: sharding.local_tree(v, z1, rt)
                     for k, v in load_tree(path, f"s{i}/").items()}
            _, _, nxt, m = step_fn(params, state, i, batch)
            assert nxt == i + 1
            out.update({f"{name}|{i}|{k}": _tensor_np(v)
                        for k, v in m.items()})
    return out


def train_rank(rank, in_dir, out_dir, cases):
    torch.set_num_threads(1)
    rt = mesh_lib.make_runtime(mesh_lib.make_smoke_mesh(2, 2))
    _save(out_dir, rank, train_cases(rt, in_dir, cases))
