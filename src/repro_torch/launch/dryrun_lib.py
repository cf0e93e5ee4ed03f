"""Dry-run core: count one rank's step for every (arch x input shape x
mesh) combination (port of ``repro/launch/dryrun_lib.py``).

The JAX package lowers and compiles each step for 256 / 512 forced host
devices and reads XLA's cost analysis. The port runs rank 0's step itself,
at full width and full world size, with nothing allocated: every tensor is
on the meta device (shapes and dtypes only) and the world is the fake
backend's (``launch/mesh.py:fake_world``), whose collectives return at
once. An ``op_analysis.Counter`` counts the ops the step dispatches; the
hand kernels book their work (K11 / K13 / K12 / K10 by their shapes).
Every rank of the SPMD step does as much as rank 0, so the report
(``launch/roofline.py``) takes rank 0's counts for each.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.common import counting
from repro_torch.common.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_analysis, roofline, sharding, specs
from repro_torch.models import registry
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train import steps


def mesh_label(rt) -> str:
    return "x".join(f"{rt.axis_size((n,))}{n}"
                    for n in rt.mesh.mesh_dim_names)


def _local(tree, spec_tree, rt):
    """Each meta leaf's slice for this rank, as a tensor of its own (no
    memory either way); a non-tensor leaf (``pos``) as it is."""
    return sharding.map_tree(
        lambda t, s: sharding.local_shard(t, s, rt).clone()
        if isinstance(t, torch.Tensor) else t, tree, spec_tree)


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages a nested structure's tensors hold."""
    seen = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if not any(st is s for s in seen):
                seen.append(st)
    return sum(st.nbytes() for st in seen)


def build_step(cfg: ModelConfig, shape: InputShape, rt):
    """The rank's step on the meta device: ``(fn, args, mine)`` with
    ``fn(*args)`` the step (``make_train_step`` / ``make_prefill_step`` /
    ``make_serve_step`` under ``rt``), ``args`` the rank's meta shards of
    the parameters, its ZeRO-1 optimizer state or decode-state slices and
    the global batch or tokens, and ``mine`` what of them the rank holds
    (its rows of the batch in place of the whole)."""
    p_specs = sharding.param_shardings(cfg, registry.param_axes(cfg),
                                       registry.param_specs(cfg), rt.mesh)
    params = _local(registry.abstract_params(cfg), p_specs, rt)
    window = specs.effective_window(cfg, shape)

    if shape.kind == "train":
        opt = make_optimizer("adam")
        state = steps.init_opt_state(cfg, opt, params, rt)
        batch = specs.batch_specs(cfg, shape)
        fn = steps.make_train_step(cfg, opt, rt, window=window)
        rows = _local(batch, sharding.batch_shardings(batch, rt.mesh), rt)
        return fn, (params, state, 0, batch), (params, state, rows)

    if shape.kind == "prefill":
        batch = specs.batch_specs(cfg, shape)
        fn = steps.make_prefill_step(cfg, rt, window=window)
        rows = _local(batch, sharding.batch_shardings(batch, rt.mesh), rt)
        return fn, (params, batch), (params, rows)

    state_abs, tokens = specs.decode_specs(cfg, shape, window=window)
    s_specs = sharding.decode_state_shardings(cfg, state_abs, rt.mesh)
    state = _local(state_abs, s_specs, rt)
    fn = steps.make_serve_step(cfg, rt, window=window, state_specs=s_specs)
    rows = sharding.local_shard(
        tokens, sharding.batch_spec(tuple(tokens.shape), rt.mesh), rt)
    return fn, (params, state, tokens), (params, state, rows)


def count_step(fn, args, mine) -> Tuple[op_analysis.Counter, Dict, float]:
    """``fn(*args)`` under a counter: the counter, the rank's memory
    (argument, output and peak bytes) and the seconds it took."""
    t0 = time.time()
    with op_analysis.Counter() as counter:
        out = fn(*args)
    t_trace = time.time() - t0
    arg_bytes = _storage_bytes(mine)
    out_bytes = _storage_bytes(out)
    memory = {"argument_bytes": float(arg_bytes),
              "output_bytes": float(out_bytes),
              "peak_bytes": float(arg_bytes + counter.peak_bytes)}
    return counter, memory, t_trace


@contextlib.contextmanager
def fake_runtime(multi_pod: bool = False,
                 mesh_shape: Optional[Tuple[int, ...]] = None):
    """A fake world of as many ranks as the mesh holds, and this rank's
    runtime on it: the production mesh (``make_production_mesh``), or
    ``mesh_shape`` ((n_data, n_model) or (n_pod, n_data, n_model))."""
    dims = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    with mesh_lib.fake_world(math.prod(dims)):
        if mesh_shape is None:
            mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        else:
            mesh = mesh_lib.make_mesh(tuple(dims), ("pod", "data",
                                                    "model")[-len(dims):])
        yield mesh_lib.make_runtime(mesh)


def tag_of(mesh_name: str, multi_pod: bool, mesh_shape) -> str:
    """The report file's mesh tag: JAX's "1pod" / "2pod", or the mesh's
    name (:func:`mesh_label`) for a mesh of its own."""
    if mesh_shape is None:
        return "2pod" if multi_pod else "1pod"
    return mesh_name


def measure(arch: str, shape: Union[str, InputShape], *,
            multi_pod: bool = False,
            overrides: Optional[Dict[str, Any]] = None,
            mesh_shape: Optional[Tuple[int, ...]] = None
            ) -> Tuple[Dict[str, Any], Optional[op_analysis.Counter]]:
    """Count rank 0's step of ``arch`` at ``shape`` (a name of
    ``INPUT_SHAPES`` or an ``InputShape``) on the production mesh (16 x 16,
    or 2 x 16 x 16 with ``multi_pod``) or on ``mesh_shape`` ((n_data,
    n_model) or (n_pod, n_data, n_model)), in a fake world of as many ranks
    opened here: ``(report, counter)``, the report with JAX's keys (with
    ``counted_flops`` / ``counted_bytes``, ``t_trace_s`` for the lower and
    compile times, ``n_ops`` for the HLO text's length, and ``dtype``) and
    the counter its totals came from (per op and per booked kernel); the
    counter is None for a skipped combination."""
    cfg = registry.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape if isinstance(shape, InputShape) else INPUT_SHAPES[shape]
    ok, why = specs.shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "status": "skipped",
                "reason": why}, None

    with fake_runtime(multi_pod, mesh_shape) as rt:
        fn, args, mine = build_step(cfg, shape, rt)
        counter, memory, t_trace = count_step(fn, args, mine)
        mesh_name, n_ranks = mesh_label(rt), rt.n_devices

    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    model_flops = counting.model_flops(cfg, n_tokens, shape.kind)
    report = roofline.build_report(
        arch=arch, shape=shape.name, mesh_name=mesh_name, chips=n_ranks,
        counter=counter, model_flops=model_flops, dtype=cfg.dtype,
        memory_per_device=memory)
    result = report.to_dict()
    result.update(
        status="ok", t_trace_s=t_trace,
        params=cfg.param_count(), params_active=cfg.param_count(
            active_only=True),
        n_ops=counter.n_ops,
    )
    return result, counter


def run_one(arch: str, shape_name: Union[str, InputShape], *,
            multi_pod: bool = False, out_dir: str = "experiments/dryrun_torch",
            overrides: Optional[Dict[str, Any]] = None,
            mesh_shape: Optional[Tuple[int, ...]] = None) -> Dict[str, Any]:
    """:func:`measure`'s report, also written as JSON under ``out_dir``
    (``<arch>_<shape>_<mesh tag>.json``: JAX's "1pod" / "2pod", or the
    mesh's name for a mesh of its own)."""
    result, _ = measure(arch, shape_name, multi_pod=multi_pod,
                        overrides=overrides, mesh_shape=mesh_shape)
    if result["status"] != "ok":
        return result
    os.makedirs(out_dir, exist_ok=True)
    tag = (f"{arch}_{result['shape']}_"
           f"{tag_of(result['mesh'], multi_pod, mesh_shape)}")
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def summarize(result: Dict[str, Any]) -> str:
    if result.get("status") != "ok":
        return (f"{result['arch']:24s} {result['shape']:12s} SKIP: "
                f"{result.get('reason', '?')}")
    return (
        f"{result['arch']:24s} {result['shape']:12s} {result['mesh']:18s} "
        f"compute={result['t_compute']*1e3:8.3f}ms "
        f"mem={result['t_memory']*1e3:8.3f}ms "
        f"coll={result['t_collective']*1e3:8.3f}ms -> "
        f"{result['bottleneck']:10s} "
        f"useful={result['useful_flops_ratio']:.3f} "
        f"trace={result['t_trace_s']:.0f}s"
    )
