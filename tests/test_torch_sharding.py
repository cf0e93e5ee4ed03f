"""The port's sharding rules (``repro_torch/launch/sharding.py``) against
the JAX package's (``repro/launch/sharding.py``) on the CPU.

* Every leaf of all ten arch ids at full config, on (16, 16) and (2, 16,
  16) meshes: the port's ``param_shardings`` spec equals JAX's on an
  ``AbstractMesh`` (the port reads the axis sizes from a mapping: no
  256-rank world). Also ``logical_rules``, ``batch_spec`` and
  ``replicated``.
* On a 2 x 2 gloo world (one spawn for the file): each rank's
  ``local_shard`` of every leaf of every arch id's smoke config (and of
  phi3.5-moe's with ``fsdp``, so that "embed" shards over "data") equals
  the full leaf at the index JAX's ``NamedSharding.devices_indices_map``
  gives the same device of a 2 x 2 mesh of 4 forced host devices (a
  subprocess); ``gather`` gives the leaf back; the batch's rows too. The
  leaves are ``arange``s, so equal values mean equal positions: exact.
* ``python -m repro_torch.launch.train --mesh 2x2 --devices 4 --device
  cpu`` runs, and its bad flags raise.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from repro.launch import sharding as j_sharding
from repro.models import registry as j_registry
from repro_torch.checkpoint import store
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.launch import train as train_cli
from repro_torch.models import registry
from tests import _torch_mesh_ranks as R
from tests._subproc import run_with_devices

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHARD_CASES = [(arch, arch, False) for arch in registry.ARCH_IDS] + [
    ("phi3.5-moe-42b-a6.6b+fsdp", "phi3.5-moe-42b-a6.6b", True)]
BATCH_SHAPES = [(4, 16), (3, 16), (2, 5, 7)]


def _jax_specs(cfg, sizes, names):
    amesh = j_sharding.abstract_mesh(sizes, names)
    tree = j_sharding.param_shardings(
        cfg, j_registry.param_axes(cfg), j_registry.abstract_params(cfg),
        amesh)
    return {"/".join(k.key for k in path): tuple(s.spec) for path, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_specs_match_jax(arch, mesh):
    sizes, names = MESHES[mesh]
    jcfg, cfg = j_registry.get_config(arch), registry.get_config(arch)
    want = _jax_specs(jcfg, sizes, names)
    axis_sizes = dict(zip(names, sizes))
    got = R.flatten(sharding.param_shardings(
        cfg, registry.param_axes(cfg), registry.param_specs(cfg),
        axis_sizes))
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert spec == want[path], (path, spec, want[path])
    # at least one leaf shards over "model" (every arch id has heads or
    # an mlp dim of 16 or more)
    assert any("model" in s for s in got.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_batch_spec_and_replicated_match_jax(mesh):
    sizes, names = MESHES[mesh]
    amesh = j_sharding.abstract_mesh(sizes, names)
    axis_sizes = dict(zip(names, sizes))
    for arch in ("phi3.5-moe-42b-a6.6b", "llama3.2-1b"):
        jcfg, cfg = j_registry.get_config(arch), registry.get_config(arch)
        for pure_dp in (False, True):
            assert sharding.logical_rules(
                cfg.replace(pure_dp=pure_dp), axis_sizes) == \
                j_sharding.logical_rules(jcfg.replace(pure_dp=pure_dp), amesh)
    for shape in [(32, 16), (48, 3), (3, 16), (512,), (64, 8, 4)]:
        assert sharding.batch_spec(shape, axis_sizes) == \
            tuple(j_sharding.batch_spec(shape, amesh)), shape
    assert sharding.replicated(axis_sizes) == \
        tuple(j_sharding.replicated(amesh).spec)


def test_spec_for_fallbacks_as_jax():
    """``test_distribution.py``'s two spec_for cases on the port."""
    sizes = {"data": 16, "model": 16}
    qwen = registry.get_config("qwen2.5-3b")
    rules = sharding.logical_rules(qwen, sizes)
    assert sharding.spec_for((2048, 2, 128), ("embed", "kv_heads",
                                              "head_dim"), rules, sizes) == \
        (None, None, None)
    assert sharding.spec_for((2048, 16, 128), ("embed", "heads",
                                               "head_dim"), rules, sizes) == \
        (None, "model", None)
    phi = registry.get_config("phi3.5-moe-42b-a6.6b")  # fsdp: embed on data
    rules = sharding.logical_rules(phi, sizes)
    assert sharding.spec_for((8192, 22016), ("embed", "mlp"), rules,
                             sizes) == ("data", "model")


def _jax_device_slices():
    """{case|path: per device (ids 0-3, row-major on the 2 x 2 mesh), per
    dim [start, stop)} from JAX's NamedSharding on 4 host devices."""
    code = """
import json, jax
from repro.launch import mesh as mesh_lib, sharding
from repro.models import registry
mesh = mesh_lib.make_smoke_mesh(2, 2)
assert [d.id for d in mesh.devices.flat] == [0, 1, 2, 3]
out = {}
def slices(shd, shape):
    idx = shd.devices_indices_map(tuple(shape))
    return [[list(s.indices(n))[:2] for s, n in zip(idx[d], shape)]
            for d in mesh.devices.flat]
for name, arch, fsdp in %s:
    cfg = registry.get_config(arch, smoke=True)
    cfg = cfg.replace(fsdp=True) if fsdp else cfg
    ab = registry.abstract_params(cfg)
    sh = sharding.param_shardings(cfg, registry.param_axes(cfg), ab, mesh)
    for (path, s), (_, a) in zip(jax.tree_util.tree_flatten_with_path(sh)[0],
                                 jax.tree_util.tree_flatten_with_path(ab)[0]):
        key = "/".join(k.key for k in path)
        out[name + "|" + key] = slices(s, a.shape)
for shape in %s:
    spec = sharding.batch_spec(tuple(shape), mesh)
    out["batch|" + str(tuple(shape))] = slices(
        jax.sharding.NamedSharding(mesh, spec), shape)
print("SLICES" + json.dumps(out))
""" % (repr(SHARD_CASES), repr([list(s) for s in BATCH_SHAPES]))
    out = run_with_devices(code, n_devices=4)
    return json.loads(out.split("SLICES", 1)[1])


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The 2 x 2 world's shards (rank -> npz arrays) beside JAX's device
    slices, the JAX subprocess running while the world does."""
    out_dir = str(tmp_path_factory.mktemp("shards"))
    with ThreadPoolExecutor(1) as pool:
        jax_slices = pool.submit(_jax_device_slices)
        mesh_lib.spawn(R.shards_rank, 4, out_dir, SHARD_CASES, BATCH_SHAPES)
        slices = jax_slices.result()
    ranks = []
    for r in range(4):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks, slices


@pytest.mark.parametrize("case", [c[0] for c in SHARD_CASES])
def test_local_shards_match_jax_device_slices(shards, case):
    ranks, slices = shards
    name, arch, fsdp = next(c for c in SHARD_CASES if c[0] == case)
    cfg = R.shard_config(arch, fsdp)
    leaves = R.flatten(registry.param_specs(cfg))
    assert sorted(leaves) == sorted(k.split("|", 1)[1] for k in slices
                                    if k.startswith(case + "|"))
    n_split = 0
    for path, spec in leaves.items():
        full = np.arange(int(np.prod(spec.shape))).reshape(spec.shape)
        for r in range(4):
            want = full[tuple(slice(a, b) for a, b in
                              slices[f"{case}|{path}"][r])]
            got = ranks[r][f"{case}|{path}"]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{path} rank {r}")
            assert bool(ranks[r][f"gather|{case}|{path}"]), (path, r)
        n_split += ranks[0][f"{case}|{path}"].size < full.size
    assert n_split > 0  # some leaf is really split on the 2 x 2 mesh
    if fsdp:  # phi's embedding table shards over both axes
        assert ranks[0][f"{case}|embed/tok"].size * 4 == \
            int(np.prod(leaves["embed/tok"].shape))


@pytest.mark.parametrize("shape", BATCH_SHAPES, ids=str)
def test_batch_rows_match_jax(shards, shape):
    ranks, slices = shards
    full = np.arange(int(np.prod(shape))).reshape(shape)
    for r in range(4):
        want = full[tuple(slice(a, b) for a, b in
                          slices[f"batch|{tuple(shape)}"][r])]
        np.testing.assert_array_equal(ranks[r][f"batch|{tuple(shape)}"],
                                      want)


def test_train_launcher_on_a_2x2_mesh(tmp_path):
    """Rank 0 prints; ``--ckpt`` writes the whole leaves, gathered."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-1b", "--smoke", "--device", "cpu", "--mesh", "2x2",
         "--devices", "4", "--steps", "2", "--seq", "16", "--ckpt",
         str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    # rank 0 alone prints: one line per step, then the summary
    assert [ln.split(":")[0] for ln in lines[:2]] == ["step 0", "step 1"]
    assert "on a 2x2 mesh: 2 steps of 4x16 tokens" in lines[2]
    assert lines[3] == f"checkpointed to {tmp_path / 'ckpt'}"
    assert len(lines) == 4
    cfg = registry.get_config("llama3.2-1b", smoke=True)
    like = registry.init_params(cfg, 0, "cpu")
    params, opt = store.load(str(tmp_path / "ckpt"), like, {"m": like,
                                                             "v": like},
                             device="cpu")
    for tree in (params, opt["m"], opt["v"]):
        for path, leaf in R.flatten(tree).items():
            assert leaf.shape == R.flatten(like)[path].shape, path
    assert float(opt["v"]["layers"]["attn"]["wq"].abs().max()) > 0


@pytest.mark.parametrize("flags", ["--devices 4 --device cuda",
                                   "--mesh 2x2 --device cpu"])
def test_train_launcher_refuses_bad_flags(flags):
    # --devices on the card; a 2 x 2 mesh on a one-rank world
    with pytest.raises(ValueError, match="card|needs 4 ranks"):
        train_cli.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1",
                        *flags.split()])
