"""Training launcher: Adam (or AdaGrad) steps of an arch id's model on the
synthetic token stream (port of ``repro/launch/train.py``; ``--device``
picks the card or the CPU). An ``encdec`` model is fed zero frames, as in
the JAX package.

``--mesh AxB`` trains on an (A data x B model) mesh through the sharded
step (``train/steps.py``); A·B must equal the world's rank count.
``--devices N`` spawns N gloo ranks on the CPU, the counterpart of the JAX
launcher's forced host device count; on the card the world is the one rank
this process starts. Rank 0 prints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --device cpu --steps 5 [--mesh 2x2 --devices 4]
"""
import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--devices", type=int, default=0,
                    help="spawn N gloo ranks on the CPU (mesh n_data x "
                    "n_model)")
    ap.add_argument("--mesh", default="", help="e.g. 2x2 (data x model)")
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.launch import mesh as mesh_lib

    if args.devices:
        if args.device != "cpu":
            raise ValueError("--devices spawns gloo ranks on the CPU; on the "
                             "card the world is the one rank started")
        mesh_lib.spawn(_spawned, args.devices, args)
    elif args.mesh:
        with mesh_lib.world(args.device):
            _run(args)
    else:
        _run(args)
    return 0


def _spawned(rank: int, args) -> None:
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.devices))
    _run(args)


def _run(args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import store
    from repro_torch.common.pspec import torch_dtype
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import (init_opt_state, make_train_step,
                                         zero1_specs)

    rank = dist.get_rank() if dist.is_initialized() else 0
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    rt = specs = None
    params = registry.init_params(cfg, 0, args.device)
    if args.mesh:
        nd, nm = (int(x) for x in args.mesh.split("x"))
        if nd * nm != dist.get_world_size():
            raise ValueError(f"mesh {args.mesh} needs {nd * nm} ranks; the "
                             f"world has {dist.get_world_size()}")
        rt = mesh_lib.make_runtime(mesh_lib.make_smoke_mesh(nd, nm))
        specs = sharding.param_shardings(cfg, registry.param_axes(cfg),
                                         params, rt.mesh)
        params = sharding.local_tree(params, specs, rt)
    opt = make_optimizer(args.optimizer, lr=1e-3)
    opt_state = init_opt_state(cfg, opt, params, rt)  # ZeRO-1 on a mesh
    step_fn = make_train_step(cfg, opt, rt)
    step = 0
    t0 = time.perf_counter()
    for i, batch in enumerate(
            lm_batches(cfg.vocab_size, args.batch, args.seq, args.steps)):
        b = {k: torch.from_numpy(v).to(args.device) for k, v in batch.items()}
        if cfg.family == "encdec":
            b["frames"] = torch.zeros((args.batch, args.seq, cfg.d_model),
                                      dtype=torch_dtype(cfg.dtype),
                                      device=args.device)
        params, opt_state, step, m = step_fn(params, opt_state, step, b)
        if rank == 0:
            print(f"step {i}: loss={float(m['loss']):.4f}", flush=True)
    where = f" on a {args.mesh} mesh" if args.mesh else ""
    if rank == 0:
        print(f"{args.arch} on {args.device}{where}: {args.steps} steps of "
              f"{args.batch}x{args.seq} tokens in "
              f"{time.perf_counter() - t0:.2f}s")
    if args.ckpt:
        if rt is not None:  # the whole leaves, gathered on every rank
            params = sharding.gather_tree(params, specs, rt)
            z1 = zero1_specs(cfg, rt)
            opt_state = {k: sharding.gather_tree(v, z1, rt)
                         for k, v in opt_state.items()}
        if rank == 0:
            store.save(args.ckpt, params, opt_state)
            print(f"checkpointed to {args.ckpt}")


if __name__ == "__main__":
    sys.exit(main())
