"""The sharded prefill, serve and ZeRO-1 train steps
(``repro_torch/train/steps.py`` under a mesh) on a 2 x 2 gloo world (one
spawn for the file; rank bodies in ``tests/_torch_dryrun_ranks.py``).

Weights and batch are ``tests/_torch_llm_train.py``'s: each arch id's
smoke config (f32) with JAX's ``init_params`` weights, B = 2, S = 16.

* ``make_prefill_step(cfg, rt)``: every rank's last-position logits,
  gathered over the data axes, against the port's unsharded step and JAX's
  ``make_prefill_step(cfg, rt)`` jitted over ``param_shardings`` on a 2 x 2
  mesh of 4 host devices (a subprocess). phi3.5-moe takes the
  expert-parallel MoE there (capacity factor 8: no copy drops, so it also
  equals the dense unsharded step).
* ``make_serve_step(cfg, rt, state_specs=...)``: two greedy decode steps
  from the zero state with the state in ``decode_state_shardings``'
  slices, gathered whole after each step: the next tokens equal the
  unsharded step's and JAX's exactly, each state leaf within tolerance.
* ZeRO-1 (``make_train_step(cfg, adam, rt)`` with ``init_opt_state``'s
  slices): two steps give the parameters and Adam state of the step that
  runs Adam on whole parameter shards (the sharded step without ZeRO-1)
  bit for bit, and some leaf really is sliced over "data".

Tolerance: ``TOL`` = 1e-4 of each compared tensor's largest |value| (two
f32 computations whose sums run in other orders), as in
``tests/_torch_llm_train.py``.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from repro_torch.launch import mesh as mesh_lib
from tests import _torch_dryrun_ranks as D
from tests import _torch_llm_train as T
from tests._subproc import run_with_devices

LLAMA, PHI, MAMBA = "llama3.2-1b", "phi3.5-moe-42b-a6.6b", "mamba2-130m"
N_STEPS, MAX_LEN = 2, 8
# (name, arch, kind, moe_impl)
CASES = [("llama-prefill", LLAMA, "prefill", "auto"),
         ("phi-prefill", PHI, "prefill", "auto"),
         ("llama-serve", LLAMA, "serve", "auto"),
         ("mamba2-serve", MAMBA, "serve", "auto"),
         ("llama-zero1", LLAMA, "zero1", "auto"),
         ("mamba2-zero1", MAMBA, "zero1", "auto")]


def _flat(prefix, tree):
    return {f"{prefix}{k}": v for k, v in D.flatten(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _inputs(in_dir):
    """Each case's weights and batch (or tokens) as npz."""
    rng = np.random.default_rng(11)
    for name, arch, kind, _ in CASES:
        _, jp, cfg, _, batch = T.setup(arch)
        extra = {}
        if kind == "serve":
            extra = {f"t{i}/tokens": rng.integers(
                0, cfg.vocab_size, size=(T.B,)).astype(np.int32)
                for i in range(N_STEPS)}
            extra.update(n_steps=N_STEPS, b=T.B, len=MAX_LEN)
        if kind == "prefill":
            batch = {k: v for k, v in batch.items() if k != "labels"}
        np.savez(os.path.join(in_dir, f"{name}.npz"), **_flat("p/", jp),
                 **_flat("b/", batch), **extra)


_JAX_MESH = """
import jax, jax.numpy as jnp, numpy as np
from repro.launch import mesh as mesh_lib, sharding
from repro.models import registry
from repro.train.steps import make_prefill_step, make_serve_step

def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    return tree

mesh = mesh_lib.make_smoke_mesh(2, 2)
rt = mesh_lib.make_runtime(mesh)
out = {}
for name, arch, kind, impl in %(cases)r:
    if kind == "zero1":
        continue
    z = np.load(%(in_dir)r + "/" + name + ".npz")
    cfg = registry.get_config(arch, smoke=True).replace(
        moe_impl=impl, capacity_factor=8.0)
    p0 = unflatten({k[2:]: z[k] for k in z.files if k.startswith("p/")})
    p_abs = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), p0)
    p_sh = sharding.param_shardings(cfg, registry.param_axes(cfg), p_abs,
                                    mesh)
    params = jax.device_put(p0, p_sh)
    with mesh:
        if kind == "prefill":
            batch = {k[2:]: jnp.asarray(z[k]) for k in z.files
                     if k.startswith("b/")}
            out[name + "|logits"] = np.asarray(
                jax.jit(make_prefill_step(cfg, rt))(params, batch))
            continue
        b, n = int(z["b"]), int(z["len"])
        state = registry.init_decode_state(cfg, b, n)
        s_abs = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state)
        s_sh = sharding.decode_state_shardings(cfg, s_abs, mesh)
        t_sh = sharding.batch_shardings(
            jax.ShapeDtypeStruct((b,), jnp.int32), mesh)
        fn = jax.jit(make_serve_step(cfg, rt), in_shardings=(p_sh, s_sh, t_sh),
                     out_shardings=(t_sh, s_sh))
        state = jax.device_put(state, s_sh)
        for i in range(int(z["n_steps"])):
            tok, state = fn(params, state, jnp.asarray(z["t%%d/tokens" %% i]))
            out["%%s|%%d|tokens" %% (name, i)] = np.asarray(tok)
            for path, v in jax.tree_util.tree_flatten_with_path(state)[0]:
                key = "/".join(str(getattr(k, "key", k)) for k in path)
                if key != "pos":
                    out["%%s|%%d|s|%%s" %% (name, i, key)] = np.asarray(v)
np.savez(%(in_dir)r + "/jax.npz", **out)
print("DONE", flush=True)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    in_dir = str(tmp_path_factory.mktemp("dryrun_steps_in"))
    out_dir = str(tmp_path_factory.mktemp("dryrun_steps_out"))
    _inputs(in_dir)
    cases = [(n, a, k, i) for n, a, k, i in CASES]
    with ThreadPoolExecutor(1) as pool:
        jax_done = pool.submit(run_with_devices, _JAX_MESH % {
            "cases": cases, "in_dir": in_dir}, 4)
        mesh_lib.spawn(D.steps_rank, 4, in_dir, out_dir, cases)
        jax_done.result()
    with np.load(os.path.join(out_dir, "rank0.npz")) as z:
        port = {k: z[k] for k in z.files}
    with np.load(os.path.join(in_dir, "jax.npz")) as z:
        want = {k: z[k] for k in z.files}
    return port, want


@pytest.mark.parametrize("name", [c[0] for c in CASES
                                  if c[2] == "prefill"])
def test_sharded_prefill_matches_unsharded_and_jax(results, name):
    port, want = results
    got = port[f"{name}|logits"]
    assert got.shape == (T.B, want[f"{name}|logits"].shape[-1])
    T.close(got, port[f"{name}|ref|logits"], f"{name} vs unsharded")
    T.close(got, want[f"{name}|logits"], f"{name} vs JAX 2x2")


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[2] == "serve"])
def test_sharded_serve_matches_unsharded_and_jax(results, name):
    port, want = results
    for i in range(N_STEPS):
        tok = port[f"{name}|{i}|tokens"]
        np.testing.assert_array_equal(tok, port[f"{name}|ref|{i}|tokens"])
        np.testing.assert_array_equal(tok, want[f"{name}|{i}|tokens"])
        assert int(port[f"{name}|{i}|pos"]) == i + 1
        leaves = [k.split("|s|", 1)[1] for k in port
                  if k.startswith(f"{name}|{i}|s|")]
        assert leaves and sorted(leaves) == sorted(
            k.split("|s|", 1)[1] for k in want
            if k.startswith(f"{name}|{i}|s|"))
        for leaf in leaves:
            got = port[f"{name}|{i}|s|{leaf}"]
            T.close(got, port[f"{name}|ref|{i}|s|{leaf}"],
                    f"{name} step {i} {leaf} vs unsharded")
            T.close(got, want[f"{name}|{i}|s|{leaf}"],
                    f"{name} step {i} {leaf} vs JAX 2x2")


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[2] == "zero1"])
def test_zero1_step_equals_whole_shard_step_bit_for_bit(results, name):
    port, _ = results
    assert bool(port[f"{name}|bitwise"])
    assert int(port[f"{name}|n_sliced"]) > 0
    assert all(np.isfinite(port[f"{name}|{i}|loss"]) for i in range(2))
