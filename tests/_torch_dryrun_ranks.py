"""Rank bodies of the dry-run tests (``tests/test_torch_dryrun_count.py``,
``test_torch_dryrun_steps.py``, ``test_torch_dryrun_entry.py``): each runs
in a spawned gloo rank of a 2 x 2 world (``launch/mesh.py:spawn``) and
writes its results as JSON or npz into the directory it is given. Like
``tests/_torch_mesh_ranks.py`` this file imports torch and the port only,
so a rank starts without JAX."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.common.config import InputShape
from repro_torch.launch import dryrun_ffm, dryrun_lib, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_analysis
from repro_torch.models import registry
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train import steps
from tests._torch_mesh_ranks import flatten, load_tree


def _runtime():
    torch.set_num_threads(1)
    return mesh_lib.make_runtime(mesh_lib.make_smoke_mesh(2, 2))


def _real(tree):
    """Each meta tensor of a step's arguments as CPU zeros of its shape and
    dtype (the counts depend on shapes and dtypes only)."""
    if isinstance(tree, dict):
        return {k: _real(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_real(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype)
    return tree


def count_rank(rank, out_dir, arch, shapes):
    """Rank 0's counts of ``dryrun_lib.build_step``'s steps run on real CPU
    tensors (``shapes``: ``InputShape`` fields)."""
    rt = _runtime()
    cfg = registry.get_config(arch, smoke=True)
    out = {}
    for fields in shapes:
        shape = InputShape(*fields)
        fn, args, _ = dryrun_lib.build_step(cfg, shape, rt)
        args = _real(args)
        with op_analysis.Counter() as counter:
            fn(*args)
        out[shape.name] = {"totals": counter.totals(),
                           "ops": dict(counter.ops),
                           "kernels": dict(counter.kernels)}
    if rank == 0:
        with open(os.path.join(out_dir, "counts.json"), "w") as f:
            json.dump(out, f)


def _np(t):
    """A copy (the decode caches are written in place by the next step)."""
    t = t.detach()
    return (t.to(torch.float32) if t.is_floating_point() else t).numpy().copy()


def steps_rank(rank, in_dir, out_dir, cases):
    """The sharded prefill / serve steps and the ZeRO-1 train step at 2 x 2
    on the inputs in ``in_dir/<name>.npz`` (``p/`` weights, ``b/`` the
    batch or ``t<i>/`` each step's tokens, ``s/`` the decode state), with
    the unsharded port's results beside them (``ref|``)."""
    rt = _runtime()
    out = {}
    for name, arch, kind, impl in cases:
        cfg = registry.get_config(arch, smoke=True).replace(
            moe_impl=impl, capacity_factor=8.0)  # no MoE copy drops
        path = os.path.join(in_dir, f"{name}.npz")
        params = load_tree(path, "p/")
        specs = sharding.param_shardings(cfg, registry.param_axes(cfg),
                                         params, rt.mesh)
        mine = sharding.local_tree(params, specs, rt)
        if kind == "prefill":
            batch = load_tree(path, "b/")
            got = steps.make_prefill_step(cfg, rt)(mine, batch)
            rows = sharding.gather(got, sharding.batch_spec(
                (batch["tokens"].shape[0],) + tuple(got.shape[1:]),
                rt.mesh), rt)
            out[f"{name}|logits"] = _np(rows)
            out[f"{name}|ref|logits"] = _np(
                steps.make_prefill_step(cfg)(params, batch))
        elif kind == "serve":
            out.update(_serve_case(name, cfg, path, params, mine, rt))
        else:
            out.update(_zero1_case(name, cfg, path, params, mine, specs,
                                   rt))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _serve_case(name, cfg, path, params, mine, rt):
    """Two decode steps from the zero state, sharded (the state in
    ``decode_state_shardings``' slices, gathered whole after each step)
    and unsharded."""
    with np.load(path) as z:
        n_steps, b, max_len = (int(z[k]) for k in ("n_steps", "b", "len"))
    full = registry.init_decode_state(cfg, b, max_len, device="cpu")
    s_specs = sharding.decode_state_shardings(cfg, full, rt.mesh)
    state = sharding.map_tree(
        lambda t, s: sharding.local_shard(t, s, rt).clone()
        if isinstance(t, torch.Tensor) else t, full, s_specs)
    sharded = steps.make_serve_step(cfg, rt, state_specs=s_specs)
    plain = steps.make_serve_step(cfg)
    ref = registry.init_decode_state(cfg, b, max_len, device="cpu")
    out = {}
    for i in range(n_steps):
        toks = load_tree(path, f"t{i}/")["tokens"]
        nxt, state = sharded(mine, state, toks)
        nxt = sharding.gather(nxt, sharding.batch_spec(
            tuple(toks.shape), rt.mesh), rt)
        ref_nxt, ref = plain(params, ref, toks)
        whole = sharding.map_tree(
            lambda t, s: sharding.gather(t, s, rt)
            if isinstance(t, torch.Tensor) else t, state, s_specs)
        for pre, tok, st in (("", nxt, whole), ("ref|", ref_nxt, ref)):
            out[f"{name}|{pre}{i}|tokens"] = _np(tok)
            out[f"{name}|{pre}{i}|pos"] = np.asarray(st["pos"])
            for k, v in flatten(st).items():
                if k != "pos":
                    out[f"{name}|{pre}{i}|s|{k}"] = _np(v)
    return out


def _zero1_case(name, cfg, path, params, mine, specs, rt):
    """Two Adam steps of the ZeRO-1 step beside the step with the state on
    whole parameter shards (``sharded_loss_and_grads`` then the optimizer
    shard-local): params and the state's slices, bit for bit."""
    batch = load_tree(path, "b/")
    opt = make_optimizer("adam", lr=1e-3)
    z1 = steps.zero1_specs(cfg, rt)
    full_state = opt.init(params)
    whole_state = {k: sharding.local_tree(v, specs, rt)
                   for k, v in full_state.items()}
    z1_state = {k: sharding.local_tree(v, z1, rt)
                for k, v in full_state.items()}
    step_fn = steps.make_train_step(cfg, opt, rt)
    p_a, p_b = mine, {k: v for k, v in mine.items()}
    out, same = {}, True
    for i in range(2):
        p_a, z1_state, _, m = step_fn(p_a, z1_state, i, batch)
        _, _, grads = steps.sharded_loss_and_grads(cfg, p_b, batch, rt)
        p_b, whole_state = opt.update(grads, whole_state, p_b, i)
        for (ka, a), (_, b) in zip(flatten(p_a).items(),
                                   flatten(p_b).items()):
            same &= torch.equal(a, b)
        for k in whole_state:
            got = sharding.gather_tree(z1_state[k], z1, rt)
            want = sharding.gather_tree(whole_state[k], specs, rt)
            for a, b in zip(flatten(got).values(), flatten(want).values()):
                same &= torch.equal(a, b)
        out[f"{name}|{i}|loss"] = _np(m["loss"])
    out[f"{name}|bitwise"] = np.asarray(same)
    n_sliced = sum(any(e is not None and p is None for p, e in zip(ps, zs))
                   for ps, zs in zip(flatten(specs).values(),
                                     flatten(z1).values()))
    out[f"{name}|n_sliced"] = np.asarray(n_sliced)
    return out


def ffm_rank(rank, in_path, out_dir, cfg_kw):
    """The FFM dry run's sharded serve step at 2 x 2 on real weights
    (``in_path``: ``p/`` the weights, ``b/`` the batch): every rank's
    probabilities gathered over the request axes, sharded and
    replicated."""
    from repro_torch.common.config import FFMConfig

    rt = _runtime()
    cfg = FFMConfig(**cfg_kw)
    params = load_tree(in_path, "p/")
    batch = load_tree(in_path, "b/")
    out = {}
    for repl in (False, True):
        specs = dryrun_ffm.param_shardings(cfg, replicate=repl)
        mine = sharding.local_tree(params, specs, rt)
        prob = dryrun_ffm.make_step(cfg, "serve", rt, replicate=repl)(
            mine, batch)
        whole = sharding.gather(prob, (dryrun_ffm.request_axes(rt, repl),),
                                rt)
        out["replicated" if repl else "sharded"] = _np(whole)
    if rank == 0:
        np.savez(os.path.join(out_dir, "ffm.npz"), **out)

