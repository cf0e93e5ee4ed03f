"""Port update pipe and engine hot swap against the JAX package on the CPU.

``repro_torch``'s ``InferenceEngine.apply_update`` / ``submit_update`` and
``repro``'s, fed the same frames:

* the int8 tables after full, delta and patch frames are byte-identical to
  the JAX pipe's, with equal ``rows_requantized`` / ``blocks_requantized``
  (a delta requantizes only its touched rows and blocks), mirroring
  ``test_quantized_serving.py``'s ingest tests (touched-row merging, the
  outlier sidecar);
* scores after each swap agree with the JAX engine's (rtol 2e-4, atol 2e-5,
  the slice-1 tolerance) and the prefix cache recomputes stale entries;
* ``submit_update`` / ``flush`` / ``close``: no batch ever mixes
  generations, checked deterministically by holding the ingest thread at
  its publish.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as jdeepffm
from repro.core import quantization as JQ
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.update_pipe import UpdatePipe as JUpdatePipe
from repro_torch.checkpoint import transfer as T
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import quantization as Q
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.update_pipe import UpdatePipe

from _torch_lockcheck import torch_lock_witness  # noqa: F401

# every serving object these tests build runs under the port's lock witness
pytestmark = pytest.mark.usefixtures("torch_lock_witness")

CFG = FFMConfig(n_fields=8, context_fields=5, hash_space=2**10, k=4,
                mlp_hidden=(16, 8))
JCFG = JFFMConfig(**CFG.__dict__)
FCAND = CFG.n_fields - CFG.context_fields
TOL = dict(rtol=2e-4, atol=2e-5)
TABLES = (("ffm", "emb"), ("lr", "w"))


@pytest.fixture(autouse=True)
def _pinned_gather_cliff(monkeypatch):
    # the JAX engine's int8 gather would otherwise run a calibration probe
    monkeypatch.setenv("REPRO_CLIFF_CALIBRATE", "0")


def _np_params(model="deepffm", seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, jdeepffm.init_params(JCFG, jax.random.PRNGKey(seed), model))
    rng = np.random.default_rng(seed + 1)
    params["lr"]["w"] = rng.normal(0, 0.1, CFG.hash_space).astype(np.float32)
    params["ffm"]["emb"] = rng.normal(
        0, 0.3, params["ffm"]["emb"].shape).astype(np.float32)
    return params


def _rounds(model="deepffm", seed=0):
    """(params, touched) for a full frame, two row deltas (1-2% of the rows
    and LR entries, every dense leaf) and a dense patch."""
    rng = np.random.default_rng(seed + 7)
    p = _np_params(model, seed)
    out = [(p, None)]
    for n_rows in (12, 20):
        p = jax.tree_util.tree_map(np.array, p)
        rows = np.sort(rng.choice(CFG.hash_space, n_rows, replace=False))
        emb = p["ffm"]["emb"]
        emb[rows] += rng.normal(0, 5e-3, emb[rows].shape).astype(np.float32)
        p["lr"]["w"][rows] += np.float32(2e-3)
        p["lr"]["b"] = p["lr"]["b"] + np.float32(0.01)
        out.append((p, {"ffm/emb": rows, "lr/w": rows}))
    p = jax.tree_util.tree_map(np.array, p)
    p["ffm"]["emb"] += rng.normal(0, 1e-3, p["ffm"]["emb"].shape).astype(
        np.float32)
    out.append((p, None))
    return out


def _request(rng, n, ctx=None):
    ci = (rng.integers(0, CFG.hash_space, CFG.context_fields).astype(np.int32)
          if ctx is None else ctx)
    ki = rng.integers(0, CFG.hash_space, (n, FCAND)).astype(np.int32)
    kv = rng.uniform(0.5, 2.0, (n, FCAND)).astype(np.float32)
    return ci, np.ones(CFG.context_fields, np.float32), ki, kv


def _assert_tables_equal(got, want):
    for a, b in TABLES:
        for k in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(got[a][b][k].numpy(),
                                          np.asarray(want[a][b][k]))


@pytest.mark.parametrize("model", ["ffm", "deepffm"])
def test_ingest_tables_and_scores_match_jax_pipe(model):
    port = InferenceEngine(CFG, model, device="cpu", quantized=True)
    ref = JEngine(JCFG, model, quantized=True, host_gather=False, parallel=1)
    snd = T.Sender(device="cpu")
    rng = np.random.default_rng(11)
    batch = [_request(rng, n) for n in (3, 9, 16)]
    kinds = []
    for params, touched in _rounds(model):
        frame = snd.make_update(params_from_numpy(params, "cpu"),
                                touched=touched)
        kinds.append(T.unframe(frame).kind)
        port.apply_update(frame, snd.manifest,
                          params_from_numpy(params, "cpu"))
        ref.apply_update(frame, snd.manifest, params)
        _assert_tables_equal(port.params, ref.params)
        ps, rs = port.update_pipe().stats, ref.update_pipe().stats
        assert (ps.rows_requantized, ps.blocks_requantized) == \
            (rs.rows_requantized, rs.blocks_requantized)
        # the same batch each round: from round 2 on its contexts hit the
        # cache with stale generations and are recomputed
        for got, want in zip(port.score_batch(batch), ref.score_batch(batch)):
            np.testing.assert_allclose(got, np.asarray(want), **TOL)
        assert (port.hits, port.misses) == (ref.hits, ref.misses)
        assert (port.generation, port.weights_version) == \
            (ref.generation, ref.weights_version)
        assert (port.stats.updates_applied, port.stats.update_bytes) == \
            (ref.stats.updates_applied, ref.stats.update_bytes)
    assert kinds == [T.KIND_FULL, T.KIND_DELTA, T.KIND_DELTA, T.KIND_PATCH]
    # full and patch frames requantize every row, a delta only its touched
    # rows (the outlier sidecar could add rows, not on these small steps)
    assert port.update_pipe().stats.rows_requantized == \
        2 * CFG.hash_space + 12 + 20


def test_delta_tables_equal_a_full_requantize_of_the_wire_state():
    eng = InferenceEngine(CFG, device="cpu", quantized=True)
    snd, rcv = T.Sender(device="cpu"), T.Receiver(device="cpu")
    seen = []
    for params, touched in _rounds()[:3]:
        frame = snd.make_update(params_from_numpy(params, "cpu"),
                                touched=touched)
        eng.apply_update(frame, snd.manifest, params_from_numpy(params, "cpu"))
        rcv.apply_update(frame)
        f32 = rcv.materialize(manifest=snd.manifest,
                              like=params_from_numpy(params, "cpu"))
        want = Q.quantize_params_rows(f32)
        for a, b in TABLES:
            for k in ("codes", "scale", "zero"):
                assert torch.equal(eng.params[a][b][k], want[a][b][k])
        seen.append(eng.update_pipe().stats.rows_requantized)
    assert seen == [CFG.hash_space, CFG.hash_space + 12,
                    CFG.hash_space + 12 + 20]


def test_requantize_functions_match_reference():
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.2, (50, 4, 2)).astype(np.float32)
    lr = rng.normal(0, 0.2, 200).astype(np.float32)
    q, ql = JQ.quantize_rows(w), JQ.quantize_blocks(lr, 64)
    tq = {k: (v if isinstance(v, int) else torch.from_numpy(v))
          for k, v in q.items()}
    tql = {k: (v if isinstance(v, int) else torch.from_numpy(v))
           for k, v in ql.items()}
    before = {k: tq[k].clone() for k in ("codes", "scale", "zero")}
    w2, lr2 = w.copy(), lr.copy()
    w2[[3, 4, 17]] += 0.5
    lr2[[5, 130, 199]] -= 0.5
    ranges, eranges = [(3, 5), (17, 18)], [(5, 6), (130, 131), (199, 200)]
    got = Q.requantize_rows(tq, torch.from_numpy(w2), ranges)
    want = JQ.requantize_rows(q, w2, ranges)
    gotl = Q.requantize_blocks(tql, torch.from_numpy(lr2), eranges)
    wantl = JQ.requantize_blocks(ql, lr2, eranges)
    for k in ("codes", "scale", "zero"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
        np.testing.assert_array_equal(gotl[k].numpy(), wantl[k])
        assert torch.equal(tq[k], before[k])  # a copy; the input is intact
    assert not torch.equal(got["zero"], tq["zero"])
    params = {"ffm": {"emb": w2}, "lr": {"w": lr2, "b": np.float32(0.0)}}
    stats, jstats = {}, {}
    got = Q.quantize_params_rows(
        params_from_numpy(params, "cpu"),
        prev={"ffm": {"emb": tq}, "lr": {"w": tql}},
        touched_rows={"ffm/emb": ranges, "lr/w": eranges}, stats=stats)
    want = JQ.quantize_params_rows(
        params, prev={"ffm": {"emb": q}, "lr": {"w": ql}},
        touched_rows={"ffm/emb": ranges, "lr/w": eranges}, stats=jstats)
    assert stats == jstats == {"rows_requantized": 3, "blocks_requantized": 3}
    _assert_tables_equal(got, want)


def test_touched_leaf_rows_merges_overlapping_ranges():
    """As ``test_quantized_serving.py``'s: element ranges widening to the
    same or adjacent rows come back merged (no double requantize)."""
    manifest = [{"path": "ffm/emb", "shape": (10, 4, 2), "dtype": "float32",
                 "offset": 0},
                {"path": "lr/w", "shape": (16,), "dtype": "float32",
                 "offset": 320}]
    elems = [(2, 3), (5, 2), (15, 2), (62, 10), (81, 1), (82, 2)]
    pipe = UpdatePipe(InferenceEngine(CFG, device="cpu", quantized=True),
                      manifest=manifest)
    jpipe = JUpdatePipe(JEngine(JCFG, quantized=True, host_gather=False,
                                parallel=1), manifest=manifest)
    pipe._receiver.last_touched_elems = list(elems)
    jpipe._receiver.last_touched_elems = list(elems)
    out = pipe._touched_leaf_rows()
    assert out == jpipe._touched_leaf_rows()
    assert out["ffm/emb"] == [(0, 3), (7, 9)] and out["lr/w"] == [(1, 4)]


def test_sidecar_only_rows_requantize_on_ingest():
    """A row whose change reaches the server only through the outlier
    sidecar requantizes (its indices join the touched set), as in the JAX
    package."""
    p1 = _np_params("ffm")
    p1["ffm"]["emb"] = (p1["ffm"]["emb"] * 0.01).astype(np.float32)
    p2 = jax.tree_util.tree_map(np.array, p1)
    r, r2 = 100, 200
    p2["ffm"]["emb"][r] = 10.0   # far outside the round-1 grid -> sidecar
    p2["ffm"]["emb"][r2] += 1e-4
    snd = T.Sender(device="cpu")
    frames = [snd.make_update(params_from_numpy(p1, "cpu")),
              snd.make_update(params_from_numpy(p2, "cpu"),
                              touched={"ffm/emb": np.asarray([r2]),
                                       "lr/w": np.zeros(0, np.int64)})]
    assert T.unframe(frames[1]).is_delta
    eng = InferenceEngine(CFG, "ffm", device="cpu", quantized=True)
    ref = JEngine(JCFG, "ffm", quantized=True, host_gather=False, parallel=1)
    for f, like in zip(frames, (p1, None)):
        eng.apply_update(f, snd.manifest if like is not None else None,
                         params_from_numpy(like, "cpu") if like is not None
                         else None)
        ref.apply_update(f, snd.manifest if like is not None else None, like)
    got = Q.dequantize_rows(eng.params["ffm"]["emb"])
    np.testing.assert_allclose(got[r], 10.0, atol=1e-3)
    _assert_tables_equal(eng.params, ref.params)
    assert eng.update_pipe().stats.rows_requantized == \
        ref.update_pipe().stats.rows_requantized < 2 * CFG.hash_space


def _gen_params(v):
    """"ffm" params whose scores encode ``v``: zero embeddings (exact in
    int8) and LR weights all ``v``, so every logit is ``v * n_fields``."""
    p = jax.tree_util.tree_map(np.zeros_like, _np_params("ffm"))
    p["lr"]["w"] = np.full_like(p["lr"]["w"], v)
    return p


def test_background_ingest_never_tears_a_batch():
    """Deterministic twin of the JAX concurrency test: the ingest thread is
    held at its publish while the caller scores, so every batch is scored
    against the old generation in full; once released and flushed, against
    the new one in full — including contexts cached under the old one."""
    versions = [1.0, 3.0, 9.0]
    snd = T.Sender(mode="raw", device="cpu")  # exact wire: scores on-grid
    frames = [snd.make_update(params_from_numpy(_gen_params(v), "cpu"))
              for v in versions]
    eng = InferenceEngine(CFG, "ffm", device="cpu", quantized=True)
    eng.apply_update(frames[0], snd.manifest,
                     params_from_numpy(_gen_params(0.0), "cpu"))
    pipe = eng.update_pipe()
    at_publish, release = threading.Event(), threading.Event()
    publish = eng._publish

    def held_publish(params, version, nbytes):
        at_publish.set()
        assert release.wait(30)
        return publish(params, version, nbytes)

    eng._publish = held_publish
    rng = np.random.default_rng(0)
    batch = [(ci, cv, ki, np.ones_like(kv))
             for ci, cv, ki, kv in (_request(rng, n) for n in (2, 5, 8))]

    def scores():
        return {round(float(x), 4) for o in eng.score_batch(batch) for x in o}

    assert scores() == {versions[0] * CFG.n_fields}
    for old, new, frame in zip(versions, versions[1:], frames[1:]):
        at_publish.clear()
        release.clear()
        assert eng.submit_update(frame)
        assert at_publish.wait(30)  # decoded, quantized, prewarmed: held
        assert scores() == {old * CFG.n_fields}
        release.set()
        assert pipe.flush(timeout=30)
        assert scores() == {new * CFG.n_fields}
    assert pipe.stats.published == len(versions)
    assert pipe.stats.contexts_refreshed > 0  # prewarm ran on the thread
    assert eng.generation == len(versions)
    assert eng.weights_version == snd.version
    pipe.close(timeout=30)
    assert not pipe._thread.is_alive()
    with pytest.raises(RuntimeError):
        eng.submit_update(frames[-1])


def test_sync_ingest_waits_for_queued_frames_and_rejects_poison():
    """A synchronous ``apply_update`` never overtakes a queued frame, and a
    corrupt frame is counted as a NACK while the pipe keeps serving."""
    snd = T.Sender(mode="patch", device="cpu")
    frames = [snd.make_update(params_from_numpy(_np_params("ffm", s), "cpu"))
              for s in range(3)]
    eng = InferenceEngine(CFG, "ffm", device="cpu", quantized=True)
    pipe = eng.update_pipe(snd.manifest,
                           params_from_numpy(_np_params("ffm"), "cpu"))
    assert eng.submit_update(frames[0]) and eng.submit_update(frames[1])
    eng.apply_update(frames[2])  # flushes the queue first
    assert pipe.version == 3 and eng.weights_version == 3
    want = Q.quantize_params_rows(params_from_numpy(_np_params("ffm", 2),
                                                    "cpu"))
    for k in ("codes", "scale", "zero"):
        assert torch.equal(eng.params["ffm"]["emb"][k], want["ffm"]["emb"][k])
    bad = bytearray(frames[2])
    bad[-3] ^= 0xFF
    assert eng.submit_update(bytes(bad))
    assert pipe.flush(timeout=30)
    assert pipe.stats.frames_rejected == 1
    assert pipe.stats.last_frame_error.startswith("FrameChecksumError")
    assert eng.generation == 3
    pipe.close(timeout=30)


def test_prewarm_refreshes_cached_contexts_without_counting():
    eng = InferenceEngine(CFG, "deepffm", device="cpu", quantized=True)
    snd = T.Sender(device="cpu")
    (p1, _), (p2, t2) = _rounds()[:2]
    eng.apply_update(snd.make_update(params_from_numpy(p1, "cpu")),
                     snd.manifest, params_from_numpy(p1, "cpu"))
    rng = np.random.default_rng(5)
    batch = [_request(rng, 4) for _ in range(3)]
    eng.score_batch(batch)
    before = (dict(eng.prefix_hit_depths), eng.stats.ctx_tail_fields)
    frame = snd.make_update(params_from_numpy(p2, "cpu"), touched=t2)
    assert eng.submit_update(frame) and eng.update_pipe().flush(timeout=30)
    assert eng.update_pipe().stats.contexts_refreshed == len(batch)
    assert (dict(eng.prefix_hit_depths), eng.stats.ctx_tail_fields) == before
    got = eng.score_batch(batch)
    # every context hits at full depth under the new generation
    assert eng.prefix_hit_depths[CFG.context_fields] == len(batch)
    for req, g in zip(batch, got):
        np.testing.assert_allclose(g, eng.score_uncached(*req).numpy(), **TOL)
    eng.update_pipe().close(timeout=30)
