"""The port's serving surfaces against the JAX package's on the CPU.

* ``CTRStream.request`` equals JAX's bit for bit;
* ``FFMServer`` (``serve`` / ``serve_batch`` probabilities, stats, hot
  swaps, ``submit_update`` + ``flush_updates``) against JAX's ``FFMServer``
  fed the same frames, within ``test_system.py``'s rtol 2e-4, atol 2e-4;
  the port's ``"cuda"`` backend (its kernels' plain versions here) against
  its ``"reference"`` backend within the same;
* ``CachedServer``: ``serve`` == ``serve_uncached`` within rtol 2e-4, atol
  2e-5 (``test_paper_core.py``), the same scores, hits, misses and
  evictions as JAX's ``CachedServer`` on the same request sequence;
* ``repro_torch.quickstart.main(device="cpu")`` runs to its end.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import transfer as JT
from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as jdeepffm
from repro.data import synthetic as jsynthetic
from repro.serving.context_cache import CachedServer as JCachedServer
from repro.serving.server import FFMServer as JFFMServer
from repro_torch import quickstart
from repro_torch.checkpoint import transfer as T
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import deepffm
from repro_torch.data.synthetic import CTRStream
from repro_torch.serving.context_cache import CachedServer
from repro_torch.serving.server import FFMServer
from repro_torch.train.loop import OnlineTrainer
from repro_torch.train.pipeline import TrainingPipeline

CFG = FFMConfig(n_fields=12, context_fields=8, hash_space=2**14, k=4,
                mlp_hidden=(16, 8))
JCFG = JFFMConfig(**CFG.__dict__)
SERVER_TOL = dict(rtol=2e-4, atol=2e-4)   # test_system.py's FFMServer bound
CACHE_TOL = dict(rtol=2e-4, atol=2e-5)    # cached vs uncached


@pytest.fixture(autouse=True)
def _pinned_gather_cliff(monkeypatch):
    # the JAX engine's int8 gather consults a per-process calibration probe
    # of its host gather; pin its constant so the reference runs no probe
    monkeypatch.setenv("REPRO_CLIFF_CALIBRATE", "0")


@pytest.fixture
def closing():
    """Servers to close after the test: the JAX engines' scoring pools and
    every engine's update pipe."""
    servers = []
    yield servers
    for srv in servers:
        if hasattr(srv.engine, "close"):  # the JAX engine's scoring pool
            srv.engine.close()
        srv.engine.update_pipe().close()


def _np_params(model: str = "deepffm", seed: int = 0):
    params = jax.tree_util.tree_map(
        np.asarray, jdeepffm.init_params(JCFG, jax.random.PRNGKey(seed), model))
    rng = np.random.default_rng(seed + 1)
    params["lr"]["w"] = rng.normal(0, 0.1, CFG.hash_space).astype(np.float32)
    if "mlp" in params:
        last = f"w{len(CFG.mlp_hidden)}"
        params["mlp"][last] = rng.normal(
            0, 0.5, params["mlp"][last].shape).astype(np.float32)
    return params


def _oracle(server, ci, cv, ki, kv):
    return torch.sigmoid(server.engine.score_uncached(ci, cv, ki, kv)).numpy()


@pytest.mark.parametrize("seed", [0, 7])
def test_ctr_stream_request_matches_reference(seed):
    ours, theirs = CTRStream(CFG, seed=seed), jsynthetic.CTRStream(JCFG,
                                                                   seed=seed)
    for n in (1, 8, 16, 5):
        got, want = ours.request(n), theirs.request(n)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
        assert got[2].shape == (n, CFG.n_fields - CFG.context_fields)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_ffm_server_matches_jax_server(backend, closing):
    """One full frame into both servers; ``serve`` and ``serve_batch`` give
    JAX's probabilities as float32, with JAX's counters."""
    params = _np_params()
    snd = T.Sender(device="cpu")
    frame = snd.make_update(params_from_numpy(params, "cpu"))
    port = FFMServer(CFG, backend=backend, device="cpu")
    ref = JFFMServer(JCFG)
    closing += [port, ref]
    port.apply_update(frame, snd.manifest, params_from_numpy(params, "cpu"))
    ref.apply_update(frame, snd.manifest, params)
    stream = CTRStream(CFG, seed=7)
    reqs = [stream.request(n) for n in (8, 8, 3, 16)]
    reqs[1] = reqs[0][:2] + reqs[1][2:]  # a repeated context hits
    for req in reqs[:2]:
        got = port.serve(*req)
        assert got.dtype == np.float32 and got.shape == (req[2].shape[0],)
        np.testing.assert_allclose(got, ref.serve(*req), **SERVER_TOL)
    for got, want in zip(port.serve_batch(reqs[2:]), ref.serve_batch(reqs[2:])):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, **SERVER_TOL)
    for key in ("requests", "candidates", "rows_scored", "updates_applied",
                "update_bytes"):
        assert getattr(port.stats, key) == getattr(ref.stats, key), key
    assert port.stats.requests == 4 and port.stats.updates_applied == 1
    assert port.cache_hit_rate == ref.cache_hit_rate > 0
    assert (port.cfg, port.model) == (CFG, "deepffm")


def test_ffm_server_backends_agree(closing):
    params = params_from_numpy(_np_params(seed=3), "cpu")
    snd = T.Sender(device="cpu")
    frame = snd.make_update(params)
    servers = [FFMServer(CFG, backend=b, device="cpu")
               for b in ("cuda", "reference")]
    closing += servers
    for srv in servers:
        srv.apply_update(frame, snd.manifest, params)
    stream = CTRStream(CFG, seed=3)
    reqs = [stream.request(n) for n in (9, 1, 16)]
    a, b = (srv.serve_batch(reqs) for srv in servers)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **SERVER_TOL)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_ffm_server_cache_survives_weight_update(backend, closing):
    """As ``test_serving_engine.py``'s: a patch hot swap keeps the engine and
    its cache; a repeated context hits again and post-swap probabilities
    equal a fresh full forward on the new weights."""
    stream = CTRStream(CFG, seed=7)
    trainer = OnlineTrainer(CFG, lr=0.1, device="cpu")
    srv = FFMServer(CFG, backend=backend, device="cpu")
    closing.append(srv)
    upd = trainer.run_round(stream.batches(256, 4))
    srv.apply_update(upd, trainer.sender.manifest, trainer.params)
    engine, cache_obj = srv.engine, srv.engine._cache
    ci, cv, ki, kv = stream.request(6)
    srv.serve(ci, cv, ki, kv)
    srv.serve(ci, cv, ki, kv)
    assert engine.hits == 1
    upd2 = trainer.run_round(stream.batches(256, 4))
    assert T.unframe(upd2).is_patch
    srv.apply_update(upd2, trainer.sender.manifest, trainer.params)
    assert srv.engine is engine and engine._cache is cache_obj
    assert len(cache_obj) == 1
    assert engine.generation == 2 and engine.weights_version == 2
    probs = srv.serve(ci, cv, ki, kv)   # stale entry: recomputed
    probs2 = srv.serve(ci, cv, ki, kv)  # repeated context: a hit again
    assert engine.hits >= 2 and srv.cache_hit_rate > 0
    np.testing.assert_allclose(probs, probs2, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(probs, _oracle(srv, ci, cv, ki, kv),
                               **CACHE_TOL)


def test_ffm_server_submit_then_flush_publishes_in_order(closing):
    """Frames submitted to the port's and JAX's servers publish in order:
    after ``flush_updates`` both are at generation and version 4 and serve
    the same probabilities."""
    stream = CTRStream(CFG, seed=8)
    pipe = TrainingPipeline(CFG, lr=0.1, device="cpu")
    frames = [pipe.run_round(stream.batches(64, 2)) for _ in range(4)]
    port = FFMServer(CFG, device="cpu")
    ref = JFFMServer(JCFG)
    closing += [port, ref]
    like = pipe.params
    for f in frames:
        assert port.submit_update(f, pipe.sender.manifest, like)
        assert ref.submit_update(f, pipe.sender.manifest,
                                 jax.tree_util.tree_map(
                                     lambda t: t.numpy(), like))
    assert port.flush_updates() and ref.flush_updates()
    for srv in (port.engine, ref.engine):
        assert srv.generation == srv.weights_version == 4
    assert port.stats.updates_applied == ref.stats.updates_applied == 4
    req = stream.request(5)
    np.testing.assert_allclose(port.serve(*req), ref.serve(*req),
                               **SERVER_TOL)
    np.testing.assert_allclose(port.serve(*req), _oracle(port, *req),
                               **CACHE_TOL)


@pytest.mark.parametrize("model", ["deepffm", "ffm"])
def test_cached_server_matches_uncached_and_jax(model):
    params = _np_params(model)
    srv = CachedServer(CFG, params_from_numpy(params, "cpu"), model,
                       device="cpu")
    ref = JCachedServer(JCFG, params, model)
    stream = CTRStream(CFG, seed=3)
    for _ in range(3):
        req = stream.request(n_candidates=7)
        a = srv.serve(*req)
        np.testing.assert_allclose(a, srv.serve_uncached(*req).numpy(),
                                   **CACHE_TOL)
        np.testing.assert_allclose(a, np.asarray(ref.serve(*req)),
                                   **CACHE_TOL)
        np.testing.assert_allclose(srv.serve_uncached(*req).numpy(),
                                   np.asarray(ref.serve_uncached(*req)),
                                   **CACHE_TOL)
    assert (srv.hits, srv.misses) == (ref.hits, ref.misses)
    assert srv.engine.backend == "cuda" and srv.model == model


@pytest.mark.parametrize("max_entries", [2, 4096])
def test_cached_server_hits_and_evictions_follow_jax(max_entries):
    """``test_paper_core.py``'s sequence (a request twice, then three new
    contexts) and its eviction bound, with JAX's counters after every
    request."""
    params = _np_params(seed=1)
    srv = CachedServer(CFG, params_from_numpy(params, "cpu"),
                       max_entries=max_entries, device="cpu")
    ref = JCachedServer(JCFG, params, max_entries=max_entries)
    assert srv.max_entries == ref.max_entries == max_entries
    stream = CTRStream(CFG, seed=4)
    first = stream.request(5)
    seq = [first, first] + [stream.request(5) for _ in range(3)] + [first]
    for req in seq:
        np.testing.assert_allclose(srv.serve(*req), np.asarray(ref.serve(*req)),
                                   **CACHE_TOL)
        assert (srv.hits, srv.misses) == (ref.hits, ref.misses)
        assert len(srv._cache) == len(ref._cache)
    assert srv.hits >= 1 and srv.misses >= 4
    if max_entries == 2:
        assert len(srv._cache) <= 2


def test_cached_server_params_setter_installs_weights():
    """Setting ``params`` installs new weights (a new generation) on the
    port's and JAX's servers; both then serve the new weights' scores."""
    old, new = _np_params(seed=0), _np_params(seed=5)
    srv = CachedServer(CFG, params_from_numpy(old, "cpu"), device="cpu")
    ref = JCachedServer(JCFG, old)
    req = CTRStream(CFG, seed=6).request(9)
    srv.serve(*req)
    ref.serve(*req)
    gen = srv.engine.generation
    assert gen == ref.engine.generation
    srv.params = params_from_numpy(new, "cpu")
    ref.params = new
    assert srv.engine.generation == ref.engine.generation == gen + 1
    np.testing.assert_array_equal(srv.params["lr"]["w"].numpy(),
                                  new["lr"]["w"])
    got = srv.serve(*req)
    np.testing.assert_allclose(got, np.asarray(ref.serve(*req)), **CACHE_TOL)
    np.testing.assert_allclose(got, srv.serve_uncached(*req).numpy(),
                               **CACHE_TOL)


@pytest.mark.parametrize("n_fields,ctx_frac,k,n_cand,seed",
                         [(4, 0.2, 2, 1, 11), (7, 0.5, 4, 5, 23),
                          (12, 0.8, 8, 9, 305), (16, 0.4, 4, 3, 4096)])
def test_cached_server_any_field_split(n_fields, ctx_frac, k, n_cand, seed):
    """``test_properties.py``'s cache-equivalence property at fixed draws
    (its bound, rtol 5e-4, atol 5e-4), against JAX's server too."""
    fc = max(1, min(n_fields - 1, int(n_fields * ctx_frac)))
    cfg = FFMConfig(n_fields=n_fields, context_fields=fc, hash_space=2**10,
                    k=k, mlp_hidden=(8,))
    jcfg = JFFMConfig(**cfg.__dict__)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, jdeepffm.init_params(
        jcfg, jax.random.PRNGKey(seed % 97)))
    params["lr"]["w"] = rng.normal(0, 0.1, cfg.hash_space).astype(np.float32)
    srv = CachedServer(cfg, params_from_numpy(params, "cpu"), device="cpu")
    ref = JCachedServer(jcfg, params)
    ci = rng.integers(0, cfg.hash_space, fc).astype(np.int32)
    cv = rng.normal(1, 0.2, fc).astype(np.float32)
    ki = rng.integers(0, cfg.hash_space, (n_cand, n_fields - fc)).astype(np.int32)
    kv = rng.normal(1, 0.2, (n_cand, n_fields - fc)).astype(np.float32)
    a = srv.serve(ci, cv, ki, kv)
    np.testing.assert_allclose(a, srv.serve_uncached(ci, cv, ki, kv).numpy(),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(a, np.asarray(ref.serve(ci, cv, ki, kv)),
                               rtol=5e-4, atol=5e-4)


def test_cached_server_on_weights_from_the_wire():
    """As ``test_system.py``'s serving half: weights rebuilt by a receiver
    from the port's quantized patches serve through the cache as the
    uncached forward does, predictions within the wire's error of the
    trainer's, and a repeated context hits."""
    stream = CTRStream(CFG, seed=2)
    pipe = TrainingPipeline(CFG, lr=0.1, delta_updates=False, device="cpu")
    rcv = T.Receiver(device="cpu")
    sizes = []
    for _ in range(3):
        frame = pipe.run_round(stream.batches(256, 4))
        sizes.append(len(frame))
        rcv.apply_update(frame)
    assert sizes[1] < sizes[0] and sizes[2] < sizes[0]
    served = rcv.materialize(manifest=pipe.sender.manifest, like=pipe.params)
    srv = CachedServer(CFG, served, device="cpu")
    test = stream.sample(1024)
    idx, val = torch.from_numpy(test["idx"]), torch.from_numpy(test["val"])
    with torch.no_grad():
        p_t = deepffm.predict_proba(CFG, pipe.params, idx, val).numpy()
        p_s = deepffm.predict_proba(CFG, served, idx, val).numpy()
    assert np.abs(p_t - p_s).max() < 0.05
    ci, cv, ki, kv = stream.request(8)
    np.testing.assert_allclose(srv.serve(ci, cv, ki, kv),
                               srv.serve_uncached(ci, cv, ki, kv).numpy(),
                               **CACHE_TOL)
    srv.serve(ci, cv, ki, kv)
    assert srv.hits >= 1


def test_quickstart_runs_to_its_end():
    out = quickstart.main(device="cpu")
    assert out["weights_version"] == 3
    assert [r["weights_version"] for r in out["rounds"]] == [1, 2, 3]
    sizes = [r["update_bytes"] for r in out["rounds"]]
    assert sizes[1] < sizes[0] and sizes[2] < sizes[0]  # patches after a file
    assert out["auc"] > 0.5
    assert len(out["batched_best"]) == 4
    assert all(np.isfinite(r["loss"]) for r in out["rounds"])
    assert out["p99_ms"] >= out["p50_ms"] > 0


def test_jax_frames_reach_the_port_server(closing):
    """A JAX ``Sender``'s frames (full, then patch) applied by the port's
    ``FFMServer`` serve JAX's ``FFMServer`` probabilities."""
    params = _np_params(seed=2)
    jsnd = JT.Sender(mode="patch+quant")
    port, ref = FFMServer(CFG, device="cpu"), JFFMServer(JCFG)
    closing += [port, ref]
    stream = CTRStream(CFG, seed=9)
    for step in range(2):
        params["lr"]["w"][: 64 * (step + 1)] += 0.05
        frame = jsnd.make_update(params)
        port.apply_update(frame, jsnd.manifest,
                          params_from_numpy(params, "cpu"))
        ref.apply_update(frame, jsnd.manifest, params)
        req = stream.request(6)
        np.testing.assert_allclose(port.serve(*req), ref.serve(*req),
                                   **SERVER_TOL)
    assert T.unframe(frame).is_patch
    assert port.engine.weights_version == ref.engine.weights_version
