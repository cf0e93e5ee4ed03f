"""The dry run's entry points (``python -m repro_torch.launch.dryrun``,
``launch/dryrun_lib.py``, ``launch/dryrun_ffm.py``) on the CPU.

* ``python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape
  long_500k --out <tmp>`` exits 0 and prints ``long_500k`` (the
  counterpart of ``tests/test_distribution.py``'s slow-marked test; it
  takes seconds here); its JSON report's keys map one to one onto JAX's
  ``run_one`` dict with the renames listed in :data:`RENAMED`, and its
  ``model_flops``, ``params`` and ``params_active`` equal JAX's
  ``counting`` values. ``model_flops`` equals JAX's for every arch id x
  input shape.
* ``run_one`` on a 1 x 1 fake world with an ``InputShape`` of its own:
  no collective bytes, its report written; ``measure`` (what
  ``chip_smoke.py``'s dry-run phase calls) returns the counter its report
  was built from, K11 booked once per layer, and no counter for a
  skipped combination.
* ``run_ffm`` serve, sharded and replicated, at a 2 x 2 fake mesh: the
  sharded lookup moves bytes over "model", the replicated one none.
* The FFM dry run's sharded lookup on a 2 x 2 gloo world (rank body in
  ``tests/_torch_dryrun_ranks.py``) on real weights: every request's
  probability equals the unsharded ``predict_proba``'s bit for bit
  (exactly one rank gives each row, the others add 0.0), sharded and
  replicated, and JAX's ``predict_proba`` within
  ``tests/test_torch_training.py``'s score tolerance (rtol 1e-4, atol
  1e-6).
"""
import ast
import dataclasses
import inspect
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.common import counting as j_counting
from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as j_deepffm
from repro.launch import dryrun_lib as j_dryrun_lib
from repro.launch import roofline as j_roofline
from repro.models import registry as j_registry
from repro_torch import convert
from repro_torch.common import counting
from repro_torch.common.config import INPUT_SHAPES, FFMConfig, InputShape
from repro_torch.core import deepffm
from repro_torch.launch import dryrun_ffm, dryrun_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from tests import _torch_dryrun_ranks as D

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# JAX's key -> the port's; ``dtype`` is the port's addition
RENAMED = {"hlo_flops": "counted_flops", "hlo_bytes": "counted_bytes",
           "t_lower_s": "t_trace_s", "t_compile_s": "t_trace_s",
           "hlo_bytes_len": "n_ops"}
ADDED = {"dtype"}
SMALL_FFM = dict(n_fields=8, context_fields=4, hash_space=2**10, k=4,
                 mlp_hidden=(16, 8))
S_TOL = dict(rtol=1e-4, atol=1e-6)


def _n_tokens(shape):
    return shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                 else 1)


def _jax_run_one_keys():
    """The keys of JAX's ``run_one`` dict: its report's ``to_dict`` and
    the keywords of ``result.update(...)`` in its source."""
    rep = j_roofline.RooflineReport(
        arch="a", shape="s", mesh="m", chips=1, hlo_flops=1.0,
        hlo_bytes=1.0, collective_bytes=1.0, model_flops=1.0)
    keys = set(rep.to_dict())
    tree = ast.parse(inspect.getsource(j_dryrun_lib.run_one))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"):
            keys.update(kw.arg for kw in node.keywords)
    return keys


def test_dryrun_cli_long_500k(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "long_500k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "long_500k" in proc.stdout
    with open(tmp_path / "llama3.2-1b_long_500k_1pod.json") as f:
        res = json.load(f)
    want = {RENAMED.get(k, k) for k in _jax_run_one_keys()} | ADDED
    assert set(res) == want
    assert res["status"] == "ok" and res["chips"] == 256
    assert res["mesh"] == "16datax16model"
    jcfg = j_registry.get_config("llama3.2-1b")
    assert res["params"] == jcfg.param_count()
    assert res["params_active"] == jcfg.param_count(active_only=True)
    assert res["model_flops"] == j_counting.model_flops(
        jcfg, _n_tokens(INPUT_SHAPES["long_500k"]), "decode")
    assert res["collective_bytes"] > 0 and res["bottleneck"] == "collective"


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_model_flops_match_jax(arch):
    cfg, jcfg = registry.get_config(arch), j_registry.get_config(arch)
    for shape in INPUT_SHAPES.values():
        n = _n_tokens(shape)
        assert counting.model_flops(cfg, n, shape.kind) == \
            j_counting.model_flops(jcfg, n, shape.kind)


def test_run_one_on_a_1x1_world_with_its_own_shape(tmp_path):
    shape = InputShape("chip_train", 64, 2, "train")
    res = dryrun_lib.run_one("llama3.2-1b", shape, mesh_shape=(1, 1),
                             out_dir=str(tmp_path))
    assert res["status"] == "ok" and res["chips"] == 1
    assert res["collective_bytes"] == 0
    assert res["counted_flops"] > res["model_flops"] > 0
    assert res["memory_per_device"]["peak_bytes"] > \
        res["memory_per_device"]["argument_bytes"] > 0
    assert (tmp_path / "llama3.2-1b_chip_train_1datax1model.json").exists()
    line = dryrun_lib.summarize(res)
    assert "chip_train" in line and "trace=" in line


def test_measure_returns_the_counter_of_its_report():
    shape = InputShape("chip_train", 64, 2, "train")
    over = dataclasses.asdict(registry.get_config("llama3.2-1b", smoke=True))
    res, counter = dryrun_lib.measure("llama3.2-1b", shape, mesh_shape=(1, 1),
                                      overrides=over)
    assert res["status"] == "ok"
    assert (res["counted_flops"], res["counted_bytes"]) == (
        counter.flops, counter.bytes) and res["n_ops"] == counter.n_ops
    assert counter.kernels["flash_attention"][0] == over["n_layers"]
    res, counter = dryrun_lib.measure("seamless-m4t-large-v2", "long_500k")
    assert res["status"] == "skipped" and counter is None


def test_run_ffm_serve_sharded_and_replicated(tmp_path):
    got = {}
    for repl in (False, True):
        got[repl] = dryrun_ffm.run_ffm("serve", 1024, replicate=repl,
                                       mesh_shape=(2, 2),
                                       out_dir=str(tmp_path))
        assert got[repl]["status"] == "ok" and got[repl]["chips"] == 4
        assert got[repl]["predictions_per_s"] > 0
    assert got[False]["collective_detail"]["all-reduce_bytes"] > 0
    assert got[True]["collective_detail"]["total_bytes"] == 0
    assert sorted(os.listdir(tmp_path)) == [
        "deepffm-ctr_serve1024_2datax2model.json",
        "deepffm-ctr_serve1024_2datax2model_replicated.json"]


@pytest.fixture(scope="module")
def ffm_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_ffm")
    jcfg = JFFMConfig(**SMALL_FFM)
    tree = jax.tree_util.tree_map(
        np.asarray, j_deepffm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    batch = {"idx": rng.integers(0, jcfg.hash_space, (16, jcfg.n_fields)
                                 ).astype(np.int32),
             "val": rng.normal(size=(16, jcfg.n_fields)).astype(np.float32),
             "label": rng.integers(0, 2, 16).astype(np.float32)}
    path = str(d / "in.npz")
    np.savez(path, **{f"p/{k}": v for k, v in D.flatten(tree).items()},
             **{f"b/{k}": v for k, v in batch.items()})
    mesh_lib.spawn(D.ffm_rank, 4, path, str(d), SMALL_FFM)
    with np.load(str(d / "ffm.npz")) as z:
        got = {k: z[k] for k in z.files}
    return jcfg, tree, batch, got


def test_ffm_sharded_lookup_bit_for_bit_and_near_jax(ffm_inputs):
    jcfg, tree, batch, got = ffm_inputs
    cfg = FFMConfig(**SMALL_FFM)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = convert.params_from_numpy(tree, "cpu")
    with torch.no_grad():
        plain = deepffm.predict_proba(cfg, params,
                                      torch.from_numpy(batch["idx"]),
                                      torch.from_numpy(batch["val"])).numpy()
    want = np.asarray(j_deepffm.predict_proba(jcfg, tree, batch["idx"],
                                              batch["val"]))
    for kind in ("sharded", "replicated"):
        np.testing.assert_array_equal(got[kind], plain, err_msg=kind)
        np.testing.assert_allclose(got[kind], want, **S_TOL, err_msg=kind)
