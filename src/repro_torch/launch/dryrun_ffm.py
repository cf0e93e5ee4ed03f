"""Dry run of the paper's own model (DeepFFM) on the production mesh (port
of ``repro/launch/dryrun_ffm.py``).

How many predictions per second could a 256- or 512-card H100 deployment
of a production-scale DeepFFM (hash 2^22 x 24 fields x k = 8, ~806 M FFM
weights, a 3.2 GB f32 table) serve, by the roofline the LLM dry run uses?
Rank 0's step runs on the meta device in a fake world
(``dryrun_lib``'s method) and is counted; the bound uses the f32 peak.

* **sharded**: every leaf whose first dim is the hash space splits over
  "model"; requests split over the data axes. Each rank reads the rows of
  its requests that it owns, with zeros for the rows it does not, and a
  ``psum`` over "model" assembles them: exactly one rank gives each row
  and the others add 0.0, so the sum is the row, bit for bit.
* **replicated** (the serving-fleet pattern): every leaf whole on every
  card, and every card a data shard (requests split over all axes); no
  lookup collective.

``serve`` is ``deepffm.predict_proba``; ``train`` one SGD step (lr 0.05)
on ``deepffm.loss_fn``, whose §4.3 backward reaches K10: each rank
differentiates its share of the loss, and the gradients are summed over
the ranks that hold each leaf's slice.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_ffm
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.common import pspec, runtime
from repro_torch.common.config import FFMConfig
from repro_torch.core import deepffm
from repro_torch.launch import dryrun_lib, roofline, sharding

PROD_FFM = FFMConfig(n_fields=24, context_fields=16, hash_space=2**22, k=8,
                     mlp_hidden=(64, 32))
LR = 0.05


def param_shardings(cfg: FFMConfig, *, replicate: bool = False):
    """Spec tree of ``deepffm.param_specs(cfg)``: the hash-space dim over
    "model", unless ``replicate``."""
    def one(spec):
        parts = [None] * len(spec.shape)
        if not replicate and spec.shape and spec.shape[0] == cfg.hash_space:
            parts[0] = "model"
        return tuple(parts)

    def walk(node):
        return one(node) if pspec.is_spec(node) else \
            {k: walk(v) for k, v in node.items()}

    return walk(deepffm.param_specs(cfg))


def request_axes(rt, replicate: bool) -> Tuple[str, ...]:
    """The axes a batch's rows split over: the data axes, or every axis
    when the weights are replicated."""
    return rt.all_axes if replicate else rt.data_axes


class ShardedLookup:
    """A table split over "model" by its first dim, read through
    ``ffm.gather_rows`` / ``gather_lr`` (``gather_view``): the rank's own
    rows, zeros for the others, summed over "model" (differentiable)."""

    def __init__(self, shard: torch.Tensor, rt):
        self.shard, self.rt = shard, rt
        self.lo = rt.axis_index((rt.model_axis,)) * shard.shape[0]

    def gather_view(self, idx: torch.Tensor) -> torch.Tensor:
        n = self.shard.shape[0]
        local = idx - self.lo
        own = (local >= 0) & (local < n)
        rows = self.shard[local.clamp(0, n - 1)]
        own = own.reshape(tuple(own.shape) + (1,) * (rows.dim() - own.dim()))
        rows = torch.where(own, rows, torch.zeros((), dtype=rows.dtype,
                                                  device=rows.device))
        return runtime.psum(rows, self.rt, (self.rt.model_axis,))


def _view(params, specs, rt):
    """``params`` with each leaf split over "model" read through a
    :class:`ShardedLookup`."""
    return sharding.map_tree(
        lambda t, s: ShardedLookup(t, rt) if "model" in s else t, params,
        specs)


def make_step(cfg: FFMConfig, kind: str, rt, *, replicate: bool = False):
    """The rank's step: ``serve(params, batch) -> probabilities of its rows``
    or ``train(params, batch) -> (params', loss)``; ``params`` are the
    rank's shards (:func:`param_shardings`), ``batch`` the global batch
    (``idx``, ``val``, ``label``), of which the rank takes its rows."""
    specs = param_shardings(cfg, replicate=replicate)
    axes = request_axes(rt, replicate)

    def rows(batch):
        return {k: sharding.local_shard(v, (axes,), rt)
                for k, v in batch.items()}

    if kind == "serve":
        def serve(params, batch):
            mine = rows(batch)
            with torch.no_grad():
                return deepffm.predict_proba(cfg, _view(params, specs, rt),
                                             mine["idx"], mine["val"])
        return serve

    if kind != "train":
        raise ValueError(kind)
    # ranks holding the same rows: the model axis, unless replicated
    copies = 1 if replicate else rt.axis_size((rt.model_axis,))
    share = 1.0 / (rt.axis_size(axes) * copies)

    def train(params, batch):
        mine = rows(batch)
        leaves, treedef = tree_flatten(params)
        flat = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            loss = deepffm.loss_fn(cfg, _view(tree_unflatten(flat, treedef),
                                              specs, rt), mine)
            grads = torch.autograd.grad(loss * share, flat)

        def sgd(t, g, spec):  # the gradient summed over the leaf's holders
            g = g.contiguous()
            dist.all_reduce(g, group=rt.group(
                rt.data_axes if "model" in spec else rt.all_axes))
            return t - LR * g

        new = sharding.map_tree(sgd, params, tree_unflatten(list(grads),
                                                            treedef), specs)
        return new, runtime.psum(loss.detach() * share, rt, rt.all_axes)

    return train


def batch_specs(cfg: FFMConfig, batch: int) -> Dict[str, torch.Tensor]:
    return {"idx": torch.empty((batch, cfg.n_fields), dtype=torch.int32,
                               device="meta"),
            "val": torch.empty((batch, cfg.n_fields), device="meta"),
            "label": torch.empty((batch,), device="meta")}


def run_ffm(kind: str = "serve", batch: int = 65536, *,
            multi_pod: bool = False, replicate: bool = False,
            out_dir: str = "experiments/dryrun_torch",
            mesh_shape: Optional[Tuple[int, ...]] = None) -> Dict[str, Any]:
    """Count rank 0's ``kind`` step on ``batch`` requests (the production
    mesh, or ``mesh_shape``) in a fake world opened here; write the result
    as JSON under ``out_dir`` and return it (the JAX package's keys, with
    ``t_trace_s`` for ``t_compile_s``)."""
    cfg = PROD_FFM
    specs = param_shardings(cfg, replicate=replicate)
    with dryrun_lib.fake_runtime(multi_pod, mesh_shape) as rt:
        params = sharding.map_tree(
            lambda t, s: sharding.local_shard(t, s, rt).clone(),
            pspec.abstract(deepffm.param_specs(cfg)), specs)
        b = batch_specs(cfg, batch)
        mine = sharding.map_tree(
            lambda t: sharding.local_shard(
                t, (request_axes(rt, replicate),), rt), b)
        counter, memory, t_trace = dryrun_lib.count_step(
            make_step(cfg, kind, rt, replicate=replicate), (params, b),
            (params, mine))
        mesh_name, n_ranks = dryrun_lib.mesh_label(rt), rt.n_devices
        where = dryrun_lib.tag_of(mesh_name, multi_pod, mesh_shape)
    report = roofline.build_report(
        arch="deepffm-ctr", shape=f"{kind}_{batch}", mesh_name=mesh_name,
        chips=n_ranks, counter=counter, model_flops=0.0, dtype=cfg.dtype,
        memory_per_device=memory)
    bound = report.step_time_bound
    result = dict(
        arch="deepffm-ctr", shape=f"{kind}_{batch}", chips=n_ranks,
        mesh=mesh_name, t_compute=report.t_compute,
        t_memory=report.t_memory, t_collective=report.t_collective,
        bottleneck=report.bottleneck, step_time_bound=bound,
        predictions_per_s=batch / max(bound, 1e-12),
        params=pspec.count(deepffm.param_specs(cfg)), t_trace_s=t_trace,
        status="ok", memory_per_device=memory,
        collective_detail=report.collective_detail,
    )
    os.makedirs(out_dir, exist_ok=True)
    tag = (f"deepffm-ctr_{kind}{batch}_{where}"
           + ("_replicated" if replicate else ""))
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


COMBOS = (("serve", 65536, False), ("serve", 65536, True),
          ("train", 8192, False))


def main() -> int:
    for kind, batch, repl in COMBOS:
        for mp in (False, True):
            t0 = time.time()
            r = run_ffm(kind, batch, multi_pod=mp, replicate=repl)
            print(f"{r['arch']} {r['shape']:14s} "
                  f"{('replicated' if repl else 'sharded'):10s} "
                  f"{r['mesh']:20s} bound={r['step_time_bound']*1e3:.3f}ms "
                  f"bottleneck={r['bottleneck']} "
                  f"preds/s={r['predictions_per_s']:,.0f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
