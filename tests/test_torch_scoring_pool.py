"""The port's parallel span pipeline and ``ScoringPool`` on the CPU (the twin
of ``tests/test_fused_scoring.py:325-500``).

* bit parity with the single-stream engine for ``parallel`` in {1, 2, 4},
  on int8-fused, int8-staged and f32-staged engines (ragged batches, shared
  contexts, an empty slate), held also while concurrent callers race
  streaming updates (no torn ``(params, generation)`` snapshot);
* stats recorded once per caller batch, however many spans;
* span planning, fixed dispatch order, buffer recycling keyed by shape,
  dtype and device, the drain on error, and a released buffer not handed
  out again before its device event has completed.

Every test runs under the port's lock-order witness.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as jdeepffm
from repro_torch.checkpoint import transfer
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.serving.engine import (InferenceEngine, ScoringPool,
                                        ServeStats, auto_parallel_workers)

from _torch_lockcheck import torch_lock_witness  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_lock_witness")

CFG = FFMConfig(n_fields=12, context_fields=8, hash_space=2**13, k=4,
                mlp_hidden=(16,))
JCFG = JFFMConfig(**CFG.__dict__)
FC, FCAND = CFG.context_fields, CFG.n_fields - CFG.context_fields


def _params(seed=0):
    params = jax.tree_util.tree_map(np.asarray, jdeepffm.init_params(
        JCFG, jax.random.PRNGKey(seed), "ffm"))
    params["lr"]["w"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed + 1), params["lr"]["w"].shape)) * 0.1
    return params_from_numpy(params, "cpu")


def _req(rng, n_cand, ctx=None):
    ci, cv = ctx if ctx is not None else (
        rng.integers(0, CFG.hash_space, FC).astype(np.int32),
        rng.normal(1, 0.25, FC).astype(np.float32))
    return (ci, cv,
            rng.integers(0, CFG.hash_space, (n_cand, FCAND)).astype(np.int32),
            rng.normal(1, 0.25, (n_cand, FCAND)).astype(np.float32))


def _engine(params, *, quantized, fused, **kw):
    return InferenceEngine(CFG, "ffm", params=params, device="cpu",
                           prefix_stride=4, quantized=quantized, fused=fused,
                           warmup_buckets=(8, 32), **kw)


@pytest.mark.parametrize("quantized,fused",
                         [(True, True), (True, False), (False, False)],
                         ids=["int8-fused", "int8-staged", "f32-staged"])
def test_parallel_bit_parity_across_worker_counts(quantized, fused):
    params = _params(9)
    outs = {}
    for workers in (1, 2, 4):
        eng = _engine(params, quantized=quantized, fused=fused,
                      parallel=workers)
        assert eng.parallel == workers
        rng = np.random.default_rng(19)  # identical traffic per arm
        hot = (rng.integers(0, CFG.hash_space, FC).astype(np.int32),
               rng.normal(1, 0.25, FC).astype(np.float32))
        batches = []
        for n_req, n_cand in [(1, 3), (3, 17), (8, 32), (5, 9)]:
            batches.append([_req(rng, n_cand, ctx=hot if s % 2 else None)
                            for s in range(n_req)])
        batches.append([_req(rng, 4),
                        (hot[0], hot[1], np.zeros((0, FCAND), np.int32),
                         np.zeros((0, FCAND), np.float32))])
        outs[workers] = [o for reqs in batches for o in eng.score_batch(reqs)]
        eng.close()
    for workers in (2, 4):
        assert len(outs[workers]) == len(outs[1])
        for got, want in zip(outs[workers], outs[1]):
            np.testing.assert_array_equal(got, want)


def test_parallel_scoring_concurrent_callers_while_updates_stream():
    """Concurrent callers x 4 workers x streaming updates: every batch
    scores from one published generation (zero rows quantize exactly, so a
    valid score is exactly v * n_fields), and at every generation the
    parallel engine equals a single-stream engine bit for bit."""
    versions = [float(3 ** i) for i in range(4)]

    def params_v(v):
        p = {"lr": {"w": torch.full((CFG.hash_space,), v),
                    "b": torch.zeros(())},
             "ffm": {"emb": torch.zeros((CFG.hash_space, CFG.n_fields,
                                         CFG.k))}}
        return p

    def make(parallel):
        eng = InferenceEngine(CFG, "ffm", quantized=True, fused=True,
                              params=params_v(versions[0]), device="cpu",
                              parallel=parallel, warmup_buckets=(4, 8))
        snd = transfer.Sender(mode="raw", device="cpu")
        updates = [snd.make_update(params_v(v)) for v in versions]
        eng.update_pipe(snd.manifest, params_v(0.0))
        return eng, updates

    par, par_updates = make(4)
    single, single_updates = make(1)
    valid = {round(v * CFG.n_fields, 3) for v in versions}
    errors, stop = [], threading.Event()
    rng0 = np.random.default_rng(29)
    parity_reqs = [
        (rng0.integers(0, CFG.hash_space, FC).astype(np.int32),
         np.ones(FC, np.float32),
         rng0.integers(0, CFG.hash_space, (12, FCAND)).astype(np.int32),
         np.ones((12, FCAND), np.float32))
        for _ in range(6)]

    def scorer(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            reqs = []
            for _ in range(rng.integers(2, 7)):
                ci = rng.integers(0, CFG.hash_space, FC).astype(np.int32)
                ki = rng.integers(0, CFG.hash_space,
                                  (rng.integers(1, 9), FCAND)).astype(np.int32)
                reqs.append((ci, np.ones(FC, np.float32), ki,
                             np.ones(ki.shape, np.float32)))
            got = {round(float(x), 3) for o in par.score_batch(reqs)
                   for x in o}
            if not got <= valid:
                errors.append(got - valid)
            if len(got) > 1:  # one snapshot per batch
                errors.append(got)

    threads = [threading.Thread(target=scorer, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    try:
        for gen, (up, us) in enumerate(zip(par_updates, single_updates)):
            if gen:
                par.submit_update(up)
                single.submit_update(us)
                assert par.update_pipe().flush(timeout=30.0)
                assert single.update_pipe().flush(timeout=30.0)
            assert par.generation == single.generation
            want = single.score_batch(parity_reqs)
            got = par.score_batch(parity_reqs)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g, w)
            time.sleep(0.02)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert par.generation == len(versions) - 1
    for eng in (par, single):
        eng.update_pipe().close()
        eng.close()


def test_parallel_stats_record_once_per_caller_batch():
    params = _params()
    rng = np.random.default_rng(23)
    sizes = (3, 9, 17, 5, 12, 2, 8, 1)
    for workers in (1, 4):
        eng = _engine(params, quantized=True, fused=True, parallel=workers)
        eng.score_batch([_req(rng, n) for n in sizes])
        assert eng.stats.requests == len(sizes)
        assert len(eng.stats._latencies_s) == len(sizes)
        assert eng.stats.candidates == sum(sizes)
        eng.close()
    a, b = ServeStats(), ServeStats()
    a.record(0.1, 10, requests=2)
    a.rows_scored = 7
    b.record(0.2, 5)
    b.rows_scored = 3
    b.failovers, b.hedged_calls, b.last_degraded = 2, 1, True
    a.merge(b)
    assert (a.requests, a.candidates, a.rows_scored) == (3, 15, 10)
    assert (a.failovers, a.hedged_calls, a.last_degraded) == (2, 1, True)
    assert a.seconds == pytest.approx(0.3)
    assert list(a._latencies_s) == [0.1, 0.1, 0.2]


def test_parallel_span_planning_and_pool_mechanics():
    eng = _engine(_params(), quantized=True, fused=True, parallel=4)
    assert eng._plan_spans(1) == [(0, 1)]
    assert eng._plan_spans(8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert eng._plan_spans(5) == [(0, 2), (2, 3), (3, 4), (4, 5)]
    assert eng._plan_spans(3) == [(0, 1), (1, 2), (2, 3)]
    eng.close()
    single = _engine(_params(), quantized=True, fused=True)
    assert single.parallel == 1 and single._plan_spans(8) == [(0, 8)]
    single.close()
    auto = InferenceEngine(CFG, "ffm", device="cpu", parallel=None)
    assert auto.parallel == auto_parallel_workers()
    assert auto_parallel_workers(1) == 1
    assert auto_parallel_workers(2) == 2
    assert auto_parallel_workers(64) == 4

    pool = ScoringPool(2)
    buf = pool.acquire((4, 3), torch.int8)
    assert buf.shape == (4, 3) and buf.dtype == torch.int8
    pool.release(buf)
    assert pool.acquire((4, 3), torch.int8) is buf  # recycled
    assert pool.acquire((4, 3), torch.float32) is not buf  # keyed by dtype
    pool.release(buf)
    assert pool.acquire((3, 4), torch.int8) is not buf  # keyed by shape
    for _ in range(5):  # at most two per worker are kept
        pool.release(torch.empty(2))
    assert len(pool._buffers[((2,), torch.float32, torch.device("cpu"))]) == 4
    order = []

    def prep(i):
        def go():
            time.sleep(0.002 * (5 - i))  # later preps finish *earlier*
            order.append(("p", i))
            return i
        return go

    def dispatch(i):
        order.append(("d", i))
        return i * 10

    assert pool.run([prep(i) for i in range(5)], dispatch) == [
        0, 10, 20, 30, 40]
    assert [i for k, i in order if k == "d"] == [0, 1, 2, 3, 4]
    pool.shutdown()


def test_pool_run_drains_in_flight_prepares_on_error():
    """A failing dispatch: the prepares still in flight finish before the
    first error re-raises, their errors are counted, and the pool keeps
    serving."""
    pool = ScoringPool(2)
    finished = []

    def prep(i):
        def go():
            if i == 3:
                raise KeyError("secondary")
            time.sleep(0.01)
            finished.append(i)
            return i
        return go

    def dispatch(i):
        if i == 1:
            raise RuntimeError("first")
        return i

    with pytest.raises(RuntimeError, match="first"):
        pool.run([prep(i) for i in range(5)], dispatch)
    # window 3: preps 0-2 were submitted before dispatch 0, prep 3 before
    # dispatch 1 raised; 2 finished before run returned, 3's error was
    # counted, 4 never ran
    assert sorted(finished) == [0, 1, 2]
    assert pool.drain_errors == 1
    assert isinstance(pool.last_drain_error, KeyError)
    assert pool.run([prep(0), prep(2)], lambda i: i + 1) == [1, 3]
    pool.shutdown()


def test_engine_span_error_leaves_the_engine_serving(monkeypatch):
    """A span that fails mid-batch raises to the caller; the drain leaves
    the engine's pool usable and the next batch bit-identical."""
    params = _params(3)
    eng = _engine(params, quantized=True, fused=False, parallel=4)
    rng = np.random.default_rng(5)
    reqs = [_req(rng, 9) for _ in range(6)]
    want = eng.score_batch(reqs)
    real = eng._forward_args
    calls = []

    def fail(*_):
        raise RuntimeError("span failed")

    def flaky(*a, **kw):
        # a span's forward is built in its prepare and run in its dispatch:
        # the second span's dispatch fails
        fn, args = real(*a, **kw)
        calls.append(1)
        return (fail if len(calls) == 2 else fn), args

    monkeypatch.setattr(eng, "_forward_args", flaky)
    with pytest.raises(RuntimeError, match="span failed"):
        eng.score_batch(reqs)
    monkeypatch.setattr(eng, "_forward_args", real)
    for got, w in zip(eng.score_batch(reqs), want):
        np.testing.assert_array_equal(got, w)
    eng.close()


class _Event:
    """A device event's host face: done once ``synchronize`` returned."""

    def __init__(self):
        self.done = threading.Event()
        self.waited = False

    def query(self):
        return self.done.is_set()

    def synchronize(self):
        self.waited = True
        assert self.done.wait(timeout=5.0)


def test_released_buffer_waits_for_its_task_event():
    """A buffer released with the event behind its last device work is not
    handed out again before that event has completed."""
    pool = ScoringPool(1)
    buf = pool.acquire((8, 4), torch.float32)
    ev = _Event()
    pool.release(buf, ev)
    got, t_done = [], []

    def acquirer():
        got.append(pool.acquire((8, 4), torch.float32))
        t_done.append(time.monotonic())

    t = threading.Thread(target=acquirer)
    t.start()
    time.sleep(0.05)
    assert not got  # still waiting on the in-flight task
    t_event = time.monotonic()
    ev.done.set()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert got[0] is buf and ev.waited and t_done[0] >= t_event
    pool.shutdown()
