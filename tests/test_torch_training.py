"""The port's online-training path against the JAX package on the CPU.

* the round steps (``make_sparse_round_step`` and the dense
  ``make_round_step``) for all four models: each microbatch starts from the
  JAX package's params and AdaGrad state, carried across, and must touch
  the same rows and land within JAX's own tolerances (params and
  accumulators rtol 2e-4, atol 1e-6; scores rtol 1e-4, atol 1e-6, as
  ``test_training_pipeline.py``); the port's sparse step equals its dense
  step; DeepFFM gradients with and without the §4.3 backward agree;
* optimizers, data, prefetcher and metrics against their JAX originals;
* the pipeline: full then delta frames, frame version == report round, a
  round's report against the JAX pipeline's from the same weights, the
  train -> serve round trip into a port ``InferenceEngine(device="cpu")``
  in every transfer mode, the port's frames decoded by the JAX receiver,
  checkpoints, and a backend the JAX package does not have
  (``tests/test_torch_hogwild.py`` covers ``hogwild`` and ``local_sgd``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.checkpoint import transfer as JT
from repro.common import metrics as jmetrics
from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as jdeepffm
from repro.data import synthetic as jsynthetic
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import pipeline as jpipeline
from repro_torch.checkpoint import layout, store, transfer as T
from repro_torch.common import metrics
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import deepffm
from repro_torch.core import quantization as Q
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.synthetic import CTRStream, feature_hash
from repro_torch.optim import make_optimizer
from repro_torch.serving.engine import InferenceEngine
from repro_torch.train.loop import OnlineTrainer
from repro_torch.train.pipeline import (TrainingPipeline, make_round_step,
                                        make_sparse_round_step, touched_paths)

CFG = FFMConfig(n_fields=8, context_fields=4, hash_space=2**12, k=4,
                mlp_hidden=(16, 8))
JCFG = JFFMConfig(**CFG.__dict__)
MODELS = ("linear", "mlp", "ffm", "deepffm")
P_TOL = dict(rtol=2e-4, atol=1e-6)       # params and accumulators
S_TOL = dict(rtol=1e-4, atol=1e-6)       # pre-update scores
ROW_LEAVES = {"linear": ("lr/w",), "mlp": ("lr/w", "emb"),
              "ffm": ("lr/w", "ffm/emb"), "deepffm": ("lr/w", "ffm/emb")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat_np(tree):
    """``{"a/b": array}`` of a numpy or tensor tree."""
    return {path: t.numpy() for path, t in
            layout.flatten_with_paths(params_from_numpy(tree, "cpu"))}


def _changed_rows(before, after, path):
    a, b = before[path], after[path]
    return np.flatnonzero((a != b).reshape(a.shape[0], -1).any(axis=1))


@pytest.mark.parametrize("step", ["sparse", "dense"])
@pytest.mark.parametrize("model", MODELS)
def test_round_step_matches_reference(model, step):
    """Four microbatches of 32; before each, the JAX params and AdaGrad
    state are handed to the port, and the port's one-microbatch round must
    touch the same rows and reach the same params, accumulators, scores and
    loss as JAX's."""
    jmaker, maker = {
        "sparse": (jpipeline.make_sparse_round_step, make_sparse_round_step),
        "dense": (jpipeline.make_round_step, make_round_step)}[step]
    jopt = jmake_optimizer("adagrad", lr=0.1)
    jround = jmaker(JCFG, model, jopt, donate=False)
    round_fn = maker(CFG, model, make_optimizer("adagrad", lr=0.1))
    params = jdeepffm.init_params(JCFG, jax.random.PRNGKey(0), model)
    state = jopt.init(params)
    stream = CTRStream(CFG, seed=1)
    for m in range(4):
        batch = {k: v[None] for k, v in stream.sample(32).items()}
        start = _flat_np({"p": _np(params), "s": _np(state)})
        tp, ts = params_from_numpy(_np(params), "cpu"), params_from_numpy(
            _np(state), "cpu")
        params, state, _, jouts = jround(params, state,
                                         jnp.asarray(m, jnp.int32), batch)
        tp, ts, step_out, outs = round_fn(tp, ts, m, batch)
        assert step_out == m + 1
        want = _flat_np({"p": _np(params), "s": _np(state)})
        got = _flat_np({"p": params_to_numpy(tp), "s": params_to_numpy(ts)})
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path], **P_TOL,
                                       err_msg=f"microbatch {m}: {path}")
        for leaf in ROW_LEAVES[model]:
            np.testing.assert_array_equal(
                _changed_rows(start, got, f"p/{leaf}"),
                _changed_rows(start, want, f"p/{leaf}"))
        np.testing.assert_allclose(outs["scores"].numpy(),
                                   np.asarray(jouts["scores"]), **S_TOL)
        np.testing.assert_allclose(outs["loss"].numpy(),
                                   np.asarray(jouts["loss"]), **S_TOL)
        for a, b in zip(outs["col_alive"], jouts["col_alive"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("model", MODELS)
def test_sparse_step_equals_dense_step(model):
    """The row-sparse step is the dense full-space step restricted to the
    touched rows (duplicate occurrences included), over a 4-microbatch
    round."""
    stream = CTRStream(CFG, seed=1)
    batches = [stream.sample(32) for _ in range(4)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    opt = make_optimizer("adagrad", lr=0.1)
    results = {}
    for name, maker in (("dense", make_round_step),
                        ("sparse", make_sparse_round_step)):
        pipe = TrainingPipeline(CFG, model, device="cpu")
        results[name] = maker(CFG, model, opt)(pipe.params, pipe.opt_state, 0,
                                               stacked)
    dense, sparse = (_flat_np({"p": r[0], "s": r[1]}) for r in
                     (results["dense"], results["sparse"]))
    for path in dense:
        np.testing.assert_allclose(sparse[path], dense[path], **P_TOL,
                                   err_msg=path)
    np.testing.assert_allclose(results["sparse"][3]["scores"].numpy(),
                               results["dense"][3]["scores"].numpy(), **S_TOL)
    touched, _ = touched_paths(batches, model)
    assert set(touched) == set(ROW_LEAVES[model])


def test_sparse_backward_grads_equal_autograd_on_deepffm():
    """The §4.3 backward (dW through the kernel path) gives autograd's
    DeepFFM gradients, and both give the JAX package's."""
    params = _np(jdeepffm.init_params(JCFG, jax.random.PRNGKey(0)))
    last = f"w{len(CFG.mlp_hidden)}"
    params["mlp"][last] = (np.random.default_rng(1).normal(
        size=params["mlp"][last].shape) * 0.3).astype(np.float32)
    batch = CTRStream(CFG, seed=2).sample(64)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for sparse in (True, False):
        tp = jax.tree_util.tree_map(
            lambda t: t.requires_grad_(), params_from_numpy(params, "cpu"))
        deepffm.loss_fn(CFG, tp, tbatch, sparse_backward=sparse).backward()
        grads[sparse] = {p: t.grad.numpy() for p, t in
                         layout.flatten_with_paths(tp)}
    jgrads = _flat_np(_np(jax.grad(lambda p: jdeepffm.loss_fn(
        JCFG, p, batch))(jax.tree_util.tree_map(jnp.asarray, params))))
    for path in jgrads:
        np.testing.assert_allclose(grads[True][path], grads[False][path],
                                   rtol=1e-5, atol=1e-6, err_msg=path)
        np.testing.assert_allclose(grads[True][path], jgrads[path],
                                   rtol=1e-5, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("name", ["adagrad", "adam"])
def test_optimizer_matches_reference(name):
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(7, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=5).astype(np.float32),
                    "d": np.float32(0.5)}}
    jopt, opt = jmake_optimizer(name, lr=0.05), make_optimizer(name, lr=0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = params_from_numpy(params, "cpu")
    ts = opt.init(tp)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=np.shape(a)).astype(np.float32), params)
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                             jp, jnp.asarray(step, jnp.int32))
        tp, ts = opt.update(params_from_numpy(grads, "cpu"), ts, tp, step)
    want, got = _flat_np({"p": _np(jp), "s": _np(js)}), _flat_np(
        {"p": params_to_numpy(tp), "s": params_to_numpy(ts)})
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-6,
                                   atol=1e-7, err_msg=path)
    with pytest.raises(ValueError):
        make_optimizer("sgd")


@pytest.mark.parametrize("drift", [0.0, 0.2])
def test_ctr_stream_and_feature_hash_match_reference(drift):
    fields = np.arange(24)[None, :].repeat(3, 0)
    values = np.random.default_rng(0).integers(0, 10**6, (3, 24))
    for space in (2**12, 2**18):
        np.testing.assert_array_equal(
            feature_hash(fields, values, space),
            jsynthetic.feature_hash(fields, values, space))
    ours = CTRStream(CFG, seed=3, drift=drift)
    theirs = jsynthetic.CTRStream(JCFG, seed=3, drift=drift)
    for b, jb in zip(ours.batches(40, 3), theirs.batches(40, 3)):
        assert b.keys() == jb.keys()
        for k in b:
            assert b[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(b[k], jb[k])


def test_metrics_match_reference():
    rng = np.random.default_rng(1)
    labels = rng.random(3000) < 0.3
    scores = np.round(labels + rng.normal(0, 1, 3000), 1)  # many ties
    assert metrics.roc_auc(labels, scores) == jmetrics.roc_auc(labels, scores)
    assert metrics.roc_auc(np.ones(4), np.arange(4.0)) == 0.5
    np.testing.assert_array_equal(metrics.rolling_auc(labels, scores, 1000),
                                  jmetrics.rolling_auc(labels, scores, 1000))
    probs = 1 / (1 + np.exp(-scores))
    assert metrics.log_loss(labels, probs) == jmetrics.log_loss(labels, probs)


def test_prefetcher_yields_in_order_and_raises_source_errors():
    pf = Prefetcher(iter(range(50)), depth=4)
    assert list(pf) == list(range(50))

    def failing():
        yield 1
        raise KeyError("source")

    pf = Prefetcher(failing(), depth=2)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="prefetch source"):
        next(pf)


def test_pipeline_emits_delta_frames_in_steady_state():
    pipe = TrainingPipeline(CFG, device="cpu")
    stream = CTRStream(CFG, seed=5)
    kinds = [T.unframe(pipe.run_round(stream.batches(64, 3))).kind
             for _ in range(3)]
    assert kinds == [T.KIND_FULL, T.KIND_DELTA, T.KIND_DELTA]
    assert [r.update_kind for r in pipe.reports] == ["full", "delta", "delta"]
    rep = pipe.reports[-1]
    assert set(rep.skip_stats) >= {"unit_skip_frac", "tile_skip_frac",
                                   "modeled_update_speedup"}
    assert 0.0 <= rep.skip_stats["unit_skip_frac"] <= 1.0
    assert rep.touched_rows > 0 and rep.examples == 192
    assert 0 < rep.update_seconds < rep.seconds and rep.examples_per_s > 0


def test_round_report_and_frame_version_agree():
    """``RoundReport.round`` == the frame's version stamp; the classic
    trainer ships full, then patch frames (deltas off)."""
    stream = CTRStream(CFG, seed=3)
    trainer = OnlineTrainer(CFG, lr=0.1, device="cpu")
    for expect, kind in ((1, T.KIND_FULL), (2, T.KIND_PATCH)):
        frame = T.unframe(trainer.run_round(stream.batches(64, 3)))
        assert trainer.reports[-1].round == frame.version == expect
        assert frame.kind == kind


@pytest.mark.parametrize("model", ["linear", "deepffm"])
def test_pipeline_round_matches_reference(model):
    """A whole ``run_round`` (3 microbatches of 64) from the JAX pipeline's
    weights: the same examples, touched rows, frame kinds and versions, and
    mean loss and progressive AUC within the scores' tolerance."""
    jpipe = jpipeline.TrainingPipeline(JCFG, model, lr=0.1)
    pipe = TrainingPipeline(CFG, model, lr=0.1, device="cpu")
    pipe.params = params_from_numpy(_np(jpipe.params), "cpu")
    pipe.opt_state = params_from_numpy(_np(jpipe.opt_state), "cpu")
    jstream, stream = (jsynthetic.CTRStream(JCFG, seed=4),
                       CTRStream(CFG, seed=4))
    for _ in range(2):
        jpipe.run_round(jstream.batches(64, 3))
        pipe.run_round(stream.batches(64, 3))
        got, want = pipe.reports[-1], jpipe.reports[-1]
        for key in ("round", "examples", "touched_rows", "update_kind"):
            assert getattr(got, key) == getattr(want, key), key
        for key in ("mean_loss", "progressive_auc"):
            np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                       **S_TOL, err_msg=key)


def _oracle(engine, ci, cv, ki, kv):
    n, fc = ki.shape[0], CFG.context_fields
    idx = np.concatenate([np.broadcast_to(ci, (n, fc)), ki], axis=1)
    val = np.concatenate([np.broadcast_to(cv, (n, fc)), kv], axis=1)
    return deepffm.forward(CFG, engine.params, torch.from_numpy(idx),
                           torch.from_numpy(val), engine.model).numpy()


@pytest.mark.parametrize("mode", T.MODES)
def test_train_serve_roundtrip(mode):
    """Trainer rounds through every transfer mode (row deltas after the
    first) into a port engine: at each generation its scores equal a
    from-scratch forward on its params, and those params match the
    trainer's within the mode's tolerance (``test_training_pipeline.py``)."""
    stream = CTRStream(CFG, seed=6)
    pipe = TrainingPipeline(CFG, lr=0.1, transfer_mode=mode, device="cpu")
    engine = InferenceEngine(CFG, device="cpu")
    for rnd in range(1, 4):
        update = pipe.run_round(stream.batches(64, 4))
        engine.apply_update(update, pipe.sender.manifest, pipe.params)
        assert engine.generation == rnd
        assert engine.weights_version == pipe.reports[-1].round == rnd
        req = stream.sample(5)
        ci, cv, ki, kv = deepffm.split_request(CFG, req["idx"], req["val"])
        np.testing.assert_allclose(engine.score(ci, cv, ki, kv),
                                   _oracle(engine, ci, cv, ki, kv),
                                   rtol=2e-4, atol=2e-5)
        tol = 5e-4 if "quant" in mode else 1e-7
        trained = dict(layout.flatten_with_paths(pipe.params))
        for path, leaf in layout.flatten_with_paths(engine.params):
            np.testing.assert_allclose(leaf.numpy(), trained[path].numpy(),
                                       atol=tol, err_msg=path)
    assert pipe.reports[-1].update_kind == "delta"  # steady state, every mode
    engine.update_pipe().close()


def test_port_frames_decode_in_the_jax_receiver():
    """The port's frames of its trained weights (full, then deltas), applied
    by the JAX package's receiver, decode to within the wire grid's bound
    of those weights."""
    stream = CTRStream(CFG, seed=8)
    pipe = TrainingPipeline(CFG, device="cpu")
    rcv = JT.Receiver()
    for _ in range(3):
        rcv.apply_update(pipe.run_round(stream.batches(64, 2)))
        want = params_to_numpy(pipe.params)
        got = _flat_np(_np(rcv.materialize(manifest=pipe.sender.manifest,
                                           like=want)))
        meta = pipe.sender._last_meta
        hi = meta.w_min + meta.bucket_size * (Q.B_MAX - 1)
        # half a bucket, plus the f32 roundings of encode and decode
        bound = Q.max_error(meta) + 8 * np.finfo(np.float32).eps * max(
            abs(meta.w_min), abs(hi))
        for path, w in _flat_np(want).items():
            assert np.abs(got[path] - w).max() <= bound, path
    assert rcv.version == 3 and pipe.reports[-1].update_kind == "delta"


def test_checkpoint_roundtrip(tmp_path):
    """``checkpoint`` / ``store.load`` give back the weights and the
    optimizer state bit for bit, and the JAX package reads the same files."""
    pipe = TrainingPipeline(CFG, "deepffm", device="cpu")
    pipe.run_round(CTRStream(CFG, seed=9).batches(32, 2))
    pipe.checkpoint(str(tmp_path / "ckpt"))
    params, opt_state = store.load(str(tmp_path / "ckpt"), pipe.params,
                                   pipe.opt_state, device="cpu")
    jparams, jopt = jstore.load(str(tmp_path / "ckpt"))
    for tree, loaded, jloaded in ((pipe.params, params, jparams),
                                  (pipe.opt_state, opt_state, jopt)):
        want = _flat_np(params_to_numpy(tree))
        for path, leaf in _flat_np(params_to_numpy(loaded)).items():
            np.testing.assert_array_equal(leaf, want[path])
        for path, leaf in jloaded.items():
            np.testing.assert_array_equal(np.asarray(leaf), want[path])
    params, opt_state = store.load(str(tmp_path / "ckpt"), device="cpu")
    assert set(params) == set(_flat_np(params_to_numpy(pipe.params)))
    store.save(str(tmp_path / "weights_only"), pipe.params)
    assert store.load(str(tmp_path / "weights_only"), device="cpu")[1] is None


@pytest.mark.parametrize("backend", ["pmap"])
def test_unported_backends_raise_as_unknown(backend):
    with pytest.raises(ValueError, match="backend must be one of"):
        TrainingPipeline(CFG, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        TrainingPipeline(CFG, backend=backend)  # before the device resolves


def round_drift(model: str, seed: int):
    """A whole 4-microbatch round (4 x 32 from ``CTRStream(seed)``) of the
    sparse step from JAX's start, without re-syncing between microbatches:
    per params leaf with elements beyond ``P_TOL`` of JAX's: their count,
    the leaf's size, and the largest such deviation with its allowance."""
    jopt = jmake_optimizer("adagrad", lr=0.1)
    params = jdeepffm.init_params(JCFG, jax.random.PRNGKey(0), model)
    state = jopt.init(params)
    tp, ts = (params_from_numpy(_np(t), "cpu") for t in (params, state))
    stream = CTRStream(CFG, seed=seed)
    batches = [stream.sample(32) for _ in range(4)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    params, state, _, _ = jpipeline.make_sparse_round_step(
        JCFG, model, jopt, donate=False)(params, state,
                                         jnp.zeros((), jnp.int32), stacked)
    make_sparse_round_step(CFG, model, make_optimizer("adagrad", lr=0.1))(
        tp, ts, 0, stacked)
    want, got = _flat_np(_np(params)), _flat_np(params_to_numpy(tp))
    out = {}
    for path, w in want.items():
        err = np.abs(got[path] - w)
        allowed = P_TOL["atol"] + P_TOL["rtol"] * np.abs(w)
        beyond = err > allowed
        if beyond.any():
            i = np.argmax(np.where(beyond, err, 0))
            out[path] = (int(beyond.sum()), w.size, float(err.flat[i]),
                         float(allowed.flat[i]))
    return out


if __name__ == "__main__":
    # The drift of whole rounds, which the tests above avoid by handing
    # JAX's state across before every microbatch (ROADMAP, Queue 3):
    #   PYTHONPATH=src python tests/test_torch_training.py
    for seed in (1, 2, 3):
        for model in MODELS:
            print(f"seed {seed} {model}: {round_drift(model, seed) or 'none'}")
