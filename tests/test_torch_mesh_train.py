"""The port's sharded train step (``repro_torch/train/steps.py``:
``make_train_step(cfg, opt, rt)`` and ``sharded_loss_and_grads``) against
the JAX package's on the CPU.

Weights, batch and tolerance are ``tests/_torch_llm_train.py``'s: each arch
id's smoke config (f32) with JAX's ``init_params`` weights (constant leaves
seeded), the ``lm_batches`` batch B = 2, S = 16 with three labels masked,
and ``TOL`` = 1e-4 of each compared tensor's largest |value|. On a 2 x 2
gloo world (one spawn for the file):

* llama3.2-1b: the global loss, ce, aux and every leaf's gradient,
  gathered from the ranks' shards, against ``jax.value_and_grad`` of the
  unsharded loss, with the batch split over "data" (the masked labels
  fall unevenly on the two data ranks) and with a batch of 3 that does not
  divide (every rank holds it whole); then 2 Adam steps, JAX's params and
  state handed across before each, each step's loss / ce / aux against
  JAX's unsharded ``make_train_step``.
* phi3.5-moe with ``moe_impl="dense"`` (every expert on every token, the
  aux loss's means over all ranks) against JAX's unsharded loss, as for
  llama.
* every other arch id (seamless' frames split with the batch, mamba2,
  zamba2, deepseek's MoE expert-parallel beside its shared experts, at
  capacity factor 8): the same against the port's unsharded
  ``loss_and_grads``, which their own tests hold to JAX's.
* phi3.5-moe with ``moe_impl="auto"``, which takes the expert-parallel MoE
  on the mesh: the same against JAX's own 2 x 2 mesh step (``jit`` over
  ``param_shardings``, a subprocess with 4 host devices), gradients and 2
  steps; every routed token stands away from a tie at each step's weights.

On a one-rank world in the test process (the card's 1 x 1 path):
llama3.2-1b's sharded step equals the unsharded one bit for bit (losses,
params and Adam state after 2 steps), and phi's gradients equal JAX's on a
1 x 1 mesh as above.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as j_registry
from repro.optim import make_optimizer as j_make_optimizer
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import moe, registry
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.steps import make_train_step
from tests import _torch_llm_train as T
from tests import _torch_mesh_ranks as R
from tests._subproc import run_with_devices

LLAMA, PHI = "llama3.2-1b", "phi3.5-moe-42b-a6.6b"
STEPS = 2
# every other arch id: the sharded step against the port's unsharded one
OTHER_ARCHS = [a for a in registry.ARCH_IDS if a not in (LLAMA, PHI)]
# (name, arch, moe_impl, kind); "whole": a batch of 3, which the two data
# ranks cannot split
WORLD_CASES = [("llama-grads", LLAMA, "auto", "grads"),
               ("llama-whole-grads", LLAMA, "auto", "grads"),
               ("llama-steps", LLAMA, "auto", "steps"),
               ("phi-dense-grads", PHI, "dense", "grads"),
               *[(a, a, "auto", "self") for a in OTHER_ARCHS],
               ("phi-grads", PHI, "auto", "grads"),
               ("phi-steps", PHI, "auto", "steps")]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(prefix, tree):
    return {f"{prefix}{k}": v for k, v in R.flatten(_np_tree(tree)).items()}


def _whole_batch(cfg):
    batch = next(lm_batches(cfg.vocab_size, 3, T.S, 1, seed=5))
    batch["labels"][1, :3] = -1
    return batch


def _jax_unsharded(in_dir):
    """JAX's unsharded references (this process) for the llama cases and
    phi's dense MoE (whose global arrays make the aux loss's means global,
    as on a mesh), and the ranks' inputs."""
    want = {}
    jcfg, jp, _, _, batch = T.setup(PHI)  # moe_impl "dense"
    cases = [("phi-dense-grads", jcfg, jp, batch)]
    jcfg, jp, _, _, batch = T.setup(LLAMA)
    cases += [("llama-grads", jcfg, jp, batch),
              ("llama-whole-grads", jcfg, jp, _whole_batch(jcfg))]
    for name, c, p0, b in cases:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        (loss, m), g = jax.jit(jax.value_and_grad(
            lambda p: j_registry.loss_fn(c, p, jb), has_aux=True))(p0)
        want[name] = {"loss": loss, **m, "g": _np_tree(g)}
        np.savez(os.path.join(in_dir, f"{name}.npz"), **_flat("b/", b),
                 **_flat("p/", p0))
    jopt = j_make_optimizer("adam", lr=T.LR)
    jstep_fn = jax.jit(j_make_train_step(jcfg, jopt))
    params, state, step = jp, jopt.init(jp), jnp.zeros((), jnp.int32)
    inputs, metrics = _flat("b/", batch), []
    for i in range(STEPS):
        inputs.update(_flat(f"p{i}/", params))
        inputs.update(_flat(f"s{i}/", state))
        params, state, step, m = jstep_fn(params, state, step,
                                          {k: jnp.asarray(v)
                                           for k, v in batch.items()})
        metrics.append(m)
    np.savez(os.path.join(in_dir, "llama-steps.npz"), n_steps=STEPS,
             **inputs)
    want["llama-steps"] = metrics
    return want


_JAX_MESH = """
import jax, jax.numpy as jnp, numpy as np
from repro.launch import mesh as mesh_lib, sharding
from repro.models import registry
from repro.optim import make_optimizer
from repro.train.steps import make_train_step

def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    return tree

def flat(prefix, tree):
    return {prefix + "/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

z = np.load(%(inp)r)
p0 = unflatten({k[2:]: z[k] for k in z.files if k.startswith("p/")})
batch = {k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("b/")}
cfg = registry.get_config(%(arch)r, smoke=True).replace(moe_impl="auto")
for name, (nd, nm), n_steps in (("2x2", (2, 2), %(steps)d),
                                ("1x1", (1, 1), 0)):
    out = {}
    mesh = mesh_lib.make_smoke_mesh(nd, nm)
    rt = mesh_lib.make_runtime(mesh)
    p_abs = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), p0)
    p_sh = sharding.param_shardings(cfg, registry.param_axes(cfg), p_abs,
                                    mesh)
    params = jax.device_put(p0, p_sh)
    opt = make_optimizer("adam", lr=%(lr)r)
    state = opt.init(params)
    step_fn = jax.jit(make_train_step(cfg, opt, rt))
    step = jnp.zeros((), jnp.int32)
    with mesh:
        (loss, m), g = jax.jit(jax.value_and_grad(
            lambda p: registry.loss_fn(cfg, p, batch, rt), has_aux=True))(
                params)
        out.update(flat("g/", g))
        for k, v in {"loss": loss, **m}.items():
            out[k] = np.asarray(v)
        for i in range(n_steps):
            out.update(flat("p%%d/" %% i, params))
            out.update(flat("s%%d/" %% i, state))
            params, state, step, m = step_fn(params, state, step, batch)
            for k, v in m.items():
                out["%%d|" %% i + k] = np.asarray(v)
    np.savez(%(out)r + name + ".npz", **out)
    print("DONE " + name, flush=True)
"""


def _jax_phi_mesh(in_dir):
    """JAX's 2 x 2 mesh gradients and steps and 1 x 1 mesh gradients of
    phi (moe_impl "auto") in a subprocess with 4 host devices; each case's
    inputs for the port are written as soon as its reference exists."""
    _, jp, _, _, batch = T.setup(PHI)

    def publish(name, arrays):
        tmp = os.path.join(in_dir, f"{name}.tmp.npz")
        np.savez(tmp, n_steps=STEPS, **_flat("b/", batch), **arrays)
        os.replace(tmp, os.path.join(in_dir, f"{name}.npz"))

    try:
        publish("phi-grads", _flat("p/", jp))
        inp = os.path.join(in_dir, "phi-jax-in.npz")
        out = os.path.join(in_dir, "phi-jax-")
        np.savez(inp, **_flat("b/", batch), **_flat("p/", jp))
        run_with_devices(_JAX_MESH % {"inp": inp, "out": out, "arch": PHI,
                                      "lr": T.LR, "steps": STEPS},
                         n_devices=4)
        res = {}
        for mesh in ("2x2", "1x1"):
            with np.load(f"{out}{mesh}.npz") as z:
                res[mesh] = {k: z[k] for k in z.files}
        publish("phi-steps", {k: v for k, v in res["2x2"].items()
                              if k[:2] in ("p0", "p1", "s0", "s1")})
    except BaseException:
        # the ranks waiting for these inputs stop at once
        open(os.path.join(in_dir, R.ABORT), "w").close()
        raise
    return res


def _one_rank_cases(in_dir):
    """The 1 x 1 cases on a one-rank gloo world in this process: phi's
    gradients against JAX's 1 x 1 mesh, and llama's sharded step against
    the unsharded one."""
    with mesh_lib.world("cpu"):
        rt = mesh_lib.make_runtime(mesh_lib.make_smoke_mesh(1, 1))
        phi = R.train_cases(rt, in_dir, [("phi-grads", PHI, "auto",
                                          "grads")])
        _, _, cfg, tp, batch = T.setup(LLAMA)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        opt = make_optimizer("adam", lr=T.LR)
        specs = sharding.param_shardings(cfg, registry.param_axes(cfg), tp,
                                         rt.mesh)
        runs = []
        for step_fn, params in ((make_train_step(cfg, opt), tp),
                                (make_train_step(cfg, opt, rt),
                                 sharding.local_tree(tp, specs, rt))):
            state, losses = opt.init(params), []
            for i in range(STEPS):
                params, state, _, m = step_fn(params, state, i, tb)
                losses.append(m)
            runs.append((params, state, losses))
    return phi, runs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    in_dir = str(tmp_path_factory.mktemp("mesh_train"))
    # the world starts on the llama cases while JAX's phi mesh runs, and
    # takes phi's when their inputs appear
    with ThreadPoolExecutor(1) as pool:
        phi_jax = pool.submit(_jax_phi_mesh, in_dir)
        llama_jax = _jax_unsharded(in_dir)
        mesh_lib.spawn(R.train_rank, 4, in_dir, in_dir, WORLD_CASES)
        phi_jax = phi_jax.result()
    ranks = []
    for r in range(4):
        with np.load(os.path.join(in_dir, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    os.makedirs(os.path.join(in_dir, "one"))
    os.replace(os.path.join(in_dir, "phi-grads.npz"),
               os.path.join(in_dir, "one", "phi-grads.npz"))
    one_phi, one_llama = _one_rank_cases(os.path.join(in_dir, "one"))
    return llama_jax, phi_jax, ranks, one_phi, one_llama


def _check_grads(got, name, want_loss, want_g):
    """``got``: one rank's arrays; ``want_g``: {leaf path: gradient}."""
    for key in ("loss", "ce", "aux"):
        T.close(got[f"{name}|{key}"], want_loss[key], f"{name} {key}")
    leaves = {k[len(name) + 3:] for k in got if k.startswith(f"{name}|g|")}
    assert leaves == set(want_g), sorted(leaves ^ set(want_g))
    for path, w in want_g.items():
        T.close(got[f"{name}|g|{path}"], w, f"{name} grad {path}")


def _check_routing(arch, params_flat):
    """Every token the port's router sees at these weights stands away from
    a tie between its k-th and (k+1)-th expert (the unsharded forward routes
    each token as the expert-parallel one does: the same f32 product per
    row)."""
    _, _, cfg, _, batch = T.setup(arch)
    params = convert.params_from_numpy(R.unflatten(params_flat), "cpu")
    routed = []
    router = moe._router

    def recording(*a):
        routed.append(router(*a))
        return routed[-1]

    moe._router = recording
    try:
        registry.forward(cfg, params, {"tokens": torch.from_numpy(
            batch["tokens"])})
    finally:
        moe._router = router
    assert len(routed) == cfg.n_layers
    for _, _, probs in routed:
        gaps, top = T._router_gaps(cfg, probs.numpy())
        assert float(gaps.min()) > 2 * T.TOL * top, gaps.min()


@pytest.mark.parametrize("case", ["llama-grads", "llama-whole-grads",
                                  "phi-dense-grads"])
def test_sharded_grads_match_jax_unsharded(results, case):
    llama_jax, _, ranks, _, _ = results
    want = llama_jax[case]
    if case.startswith("phi"):
        _check_routing(PHI, R.flatten(_np_tree(T.setup(PHI)[1])))
    for got in ranks:
        _check_grads(got, case, want, R.flatten(want["g"]))


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_sharded_grads_match_the_unsharded_port(results, arch):
    """The other families (seamless' frames split with the batch; mamba2,
    zamba2; deepseek's MoE expert-parallel with its shared experts) against
    the port's own ``loss_and_grads``, which their other tests hold to
    JAX's."""
    _, _, ranks, _, _ = results
    ref = ranks[0]
    want = {k: ref[f"{arch}|ref|{k}"] for k in ("loss", "ce", "aux")}
    grads = {k[len(arch) + 7:]: v for k, v in ref.items()
             if k.startswith(f"{arch}|ref|g|")}
    for got in ranks:
        _check_grads(got, arch, want, grads)


def test_llama_sharded_steps_match_jax(results):
    llama_jax, _, ranks, _, _ = results
    for got in ranks:
        for i, m in enumerate(llama_jax["llama-steps"]):
            for key in ("loss", "ce", "aux"):
                T.close(got[f"llama-steps|{i}|{key}"], m[key],
                        f"step {i} {key}")
    losses = [float(ranks[0][f"llama-steps|{i}|loss"]) for i in range(STEPS)]
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("mesh", ["2x2", "1x1"])
def test_phi_expert_parallel_grads_match_jax_mesh(results, mesh):
    _, phi_jax, ranks, one_phi, _ = results
    want = phi_jax[mesh]
    grads = {k[2:]: v for k, v in want.items() if k.startswith("g/")}
    _check_routing(PHI, {k[3:]: v for k, v in phi_jax["2x2"].items()
                         if k.startswith("p0/")})
    for got in (ranks if mesh == "2x2" else [one_phi]):
        _check_grads(got, "phi-grads", want, grads)
    assert float(want["aux"]) > 0


def test_phi_expert_parallel_steps_match_jax_mesh(results):
    _, phi_jax, ranks, _, _ = results
    want = phi_jax["2x2"]
    for i in range(STEPS):
        _check_routing(PHI, {k[3:]: v for k, v in want.items()
                             if k.startswith(f"p{i}/")})
        for got in ranks:
            for key in ("loss", "ce", "aux"):
                T.close(got[f"phi-steps|{i}|{key}"], want[f"{i}|{key}"],
                        f"step {i} {key}")


def test_llama_one_by_one_mesh_is_the_unsharded_step_bit_for_bit(results):
    *_, (plain, sharded) = results
    for (a_m, b_m) in zip(plain[2], sharded[2]):
        for key in ("loss", "ce", "aux"):
            assert torch.equal(a_m[key], b_m[key]), key
    for tree_a, tree_b in ((plain[0], sharded[0]), (plain[1]["m"],
                                                    sharded[1]["m"]),
                           (plain[1]["v"], sharded[1]["v"])):
        flat_a, flat_b = R.flatten(tree_a), R.flatten(tree_b)
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            assert torch.equal(flat_a[k], flat_b[k]), k
