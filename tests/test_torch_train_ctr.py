"""The port's ``python -m repro_torch.train_ctr_100m`` against the JAX
package's ``examples/train_ctr_100m.py`` on the CPU, at a small config
(hash 2^12, 8 fields of which 4 are context, k = 4, MLP (16, 8); batch 64,
5 steps) with JAX's ``init_params(PRNGKey(0))`` carried across:

* the dense route step by step against the example's loop (``jax.jit``
  of ``value_and_grad(loss_fn)``, the hand AdaGrad), JAX's params and
  accumulator handed to the port before each step, within the training
  parity tests' tolerances (params and accumulators rtol 2e-4, atol 1e-6;
  the loss rtol 1e-4, atol 1e-6; ``tests/test_torch_training.py``);
* ``run``'s dense route equals ``dense_step`` looped over the same batches,
  bit for bit, and both routes' frames (the full one, then the drifted
  weights' patch) equal the JAX ``Sender``'s on the same weights and the
  example's drift, bit for bit;
* the checkpoint round-trips bit for bit;
* the Hogwild route at one thread equals ``HogwildTrainer.train(...,
  n_threads=1)`` bit for bit (``tests/test_torch_hogwild.py`` holds that
  trainer to JAX's);
* the command line runs both routes (its config swapped for the small one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import transfer as j_transfer
from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as j_deepffm
from repro.data import synthetic as j_synthetic
from repro_torch import train_ctr_100m as T
from repro_torch.checkpoint import layout, store
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.synthetic import CTRStream
from repro_torch.kernels import _build
from repro_torch.train.hogwild import HogwildTrainer
from repro_torch.train.pipeline import _batch_tensors, _unflat
from repro_torch.train.pipeline import _flat as _tflat

CFG = FFMConfig(n_fields=8, context_fields=4, hash_space=2**12, k=4,
                mlp_hidden=(16, 8))
JCFG = JFFMConfig(**CFG.__dict__)
BATCH, STEPS = 64, 5
P_TOL = dict(rtol=2e-4, atol=1e-6)  # params and accumulators
S_TOL = dict(rtol=1e-4, atol=1e-6)  # the loss


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {p: t.numpy() for p, t in layout.flatten_with_paths(tree)}


def _equal(a, b):
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        np.array_equal(fa[k], fb[k]) for k in fa)


def _jax_start():
    return j_deepffm.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """``run``'s dense route from JAX's start."""
    return T.run(CFG, STEPS, BATCH, ckpt=str(tmp_path_factory.mktemp("ckpt")),
                 device="cpu", params=params_from_numpy(_np(_jax_start()),
                                                        "cpu"))


@pytest.fixture(scope="module")
def hogwild_run(tmp_path_factory):
    return T.run(CFG, STEPS, BATCH, hogwild=True, threads=1,
                 ckpt=str(tmp_path_factory.mktemp("ckpt")), device="cpu")


def test_dense_steps_match_example_step_by_step():
    params = _jax_start()
    acc = jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape), params)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: j_deepffm.loss_fn(JCFG, p, b)))
    for i, b in enumerate(j_synthetic.CTRStream(JCFG, seed=0).batches(
            BATCH, STEPS)):
        tp = params_from_numpy(_np(params), "cpu")
        ta = params_from_numpy(_np(acc), "cpu")
        before = dict(_build.launches)
        loss = T.dense_step(CFG, tp, ta, _batch_tensors(b, torch.device("cpu")))
        assert _build.launches == before  # CPU tensors: no kernel
        jloss, g = vg(params, b)
        acc = jax.tree_util.tree_map(lambda a, gg: a + gg * gg, acc, g)
        params = jax.tree_util.tree_map(
            lambda p, gg, a: p - 0.1 * gg / jnp.sqrt(a + 1e-10), params, g,
            acc)
        np.testing.assert_allclose(float(loss), float(jloss), **S_TOL)
        for got, want in ((tp, params), (ta, acc)):
            got, want = _flat(got), _flat(params_from_numpy(_np(want), "cpu"))
            assert got.keys() == want.keys()
            for path in want:
                np.testing.assert_allclose(got[path], want[path], **P_TOL,
                                           err_msg=f"step {i}: {path}")


def test_dense_route_equals_its_steps(dense):
    params = params_from_numpy(_np(_jax_start()), "cpu")
    acc = _unflat(params, iter(torch.zeros_like(t) for t in _tflat(params)))
    losses = [float(T.dense_step(CFG, params, acc,
                                 _batch_tensors(b, torch.device("cpu"))))
              for b in CTRStream(CFG, seed=0).batches(BATCH, STEPS)]
    assert dense["losses"] == losses and dense["examples"] == BATCH * STEPS
    assert _equal(dense["params"], params)
    assert 0.0 <= dense["auc"] <= 1.0 and dense["peak_bytes"] is None


def _jax_frames(params):
    """The example's two updates: the weights, then the drift of
    ``examples/train_ctr_100m.py:75-76``."""
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(params))
    sender = j_transfer.Sender(mode="patch+quant")
    full = sender.make_update(jp)
    drifted = jax.tree_util.tree_map(
        lambda x: x + 1e-5 * (np.random.default_rng(0).random(x.shape)
                              < 0.01), jp)
    return full, sender.make_update(drifted), drifted


@pytest.mark.parametrize("route", ["dense", "hogwild"])
def test_frames_equal_jax_sender(route, dense, hogwild_run):
    out = dense if route == "dense" else hogwild_run
    full, patch, drifted = _jax_frames(out["params"])
    assert out["frames"][0] == full and out["frames"][1] == patch
    assert len(patch) < 4 * out["n_params"]
    got = _flat(T.drift(out["params"]))
    for path, want in _flat(params_from_numpy(_np(drifted), "cpu")).items():
        np.testing.assert_array_equal(got[path], want, err_msg=path)


@pytest.mark.parametrize("route", ["dense", "hogwild"])
def test_checkpoint_round_trips(route, dense, hogwild_run):
    out = dense if route == "dense" else hogwild_run
    back, opt = store.load(out["ckpt"], like_params=out["params"],
                           device="cpu")
    assert opt is None and _equal(back, out["params"])


def test_hogwild_route_equals_trainer(hogwild_run):
    tr = HogwildTrainer(CFG, lr=T.LR, device="cpu")
    stats = tr.train(Prefetcher(CTRStream(CFG, seed=0).batches(BATCH, STEPS),
                                depth=T.DEPTH), n_threads=1)
    assert hogwild_run["losses"] == stats.losses
    assert hogwild_run["examples"] == stats.examples == BATCH * STEPS
    assert _equal(hogwild_run["params"], tr.params())


@pytest.mark.parametrize("extra", [[], ["--hogwild", "--threads", "2"]])
def test_cli_runs(extra, tmp_path, monkeypatch):
    monkeypatch.setattr(T, "CFG", CFG)
    out = T.main(["--device", "cpu", "--steps", "3", "--batch", "32",
                  "--ckpt", str(tmp_path)] + extra)
    assert out["examples"] == 96 and out["ckpt"] == str(tmp_path)
    assert (tmp_path / "weights.bin").exists()
