"""The port's fault-tolerant fleet on the CPU (the twin of
``tests/test_fault_tolerance.py``): replica failover, hedging, deadlines,
frame integrity + resync, and the deterministic fault plan.

* **Replica exactness** — a replicas=2 fleet with one replica killed
  mid-traffic stays bit-identical to a healthy fleet at every generation.
* **Breaker + prober** — injected failures fail over exactly, strike the
  replica to ``dead``, and the prober revives it once the plan exhausts.
* **Hedging** — a straggler past ``hedge_ms`` races its sibling; first
  response wins; the loser's buffer recycles.
* **Deadlines** — a slice with no answer inside ``deadline_ms`` is given
  up as flagged zero rows, never raised.
* **Frame integrity** — a dropped, truncated or bit-flipped frame NACKs
  (typed ``FrameError`` latched, the pipe thread survives); ``resync_shard``
  brings the slice back byte-exact.
* **The request path never raises** — double kills, a dead slice's
  rotation and an all-dead fleet degrade; ``flush`` does not deadlock
  behind a kill, and ``rotate_shard`` racing submit + flush does not either.
* ``FaultPlan``'s schedule is the JAX package's: the same plan corrupts a
  frame at the same byte and bit.

Every test runs under the port's lock-order witness, so an acquisition
against the declared order in any of these races fails it; no wait is
unbounded and no sleep is longer than 0.35 s.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.serving.faults import FaultPlan as JFaultPlan
from repro_torch.analysis import lock_witness as lw
from repro_torch.checkpoint import transfer
from repro_torch.common.config import FFMConfig
from repro_torch.core import deepffm
from repro_torch.launch import topology
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.faults import (FRAME_BITFLIP, FRAME_DROP,
                                        FRAME_TRUNCATE, FaultInjected,
                                        FaultPlan)
from repro_torch.serving.shard_router import ReplicaHealth, ShardRouter
from repro_torch.train.pipeline import TrainingPipeline

from _torch_lockcheck import torch_lock_witness  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_lock_witness")

CFG = FFMConfig(n_fields=8, context_fields=4, hash_space=2**12, k=4,
                mlp_hidden=(16, 8))
FC, FCAND = CFG.context_fields, CFG.n_fields - CFG.context_fields
RANGES = topology.shard_ranges(CFG.hash_space, 2)


@pytest.fixture(scope="module")
def params():
    return deepffm.init_params(CFG, 0, "deepffm", "cpu")


def _router(params=None, **kw):
    kw.setdefault("n_shards", 2)
    return ShardRouter(CFG, params=params, quantized=True, device="cpu", **kw)


def _pipe(seed):
    return TrainingPipeline(CFG, lr=0.05, seed=seed, device="cpu",
                            shard_ranges=RANGES)


def _requests(rng, n_req=5, n_cand=7):
    return [(rng.integers(0, CFG.hash_space, FC).astype(np.int32),
             rng.standard_normal(FC).astype(np.float32),
             rng.integers(0, CFG.hash_space, (n_cand, FCAND)).astype(np.int32),
             rng.standard_normal((n_cand, FCAND)).astype(np.float32))
            for _ in range(n_req)]


def _mk_batch(rng, n=64):
    return {"idx": rng.integers(0, CFG.hash_space,
                                (n, CFG.n_fields)).astype(np.int32),
            "val": rng.standard_normal((n, CFG.n_fields)).astype(np.float32),
            "label": rng.integers(0, 2, n).astype(np.float32)}


def _scores(router, reqs, **kw):
    return np.concatenate(router.score_batch(reqs, **kw))


# ---------------------------------------------------------------------------
# Replicated shards: kill-mid-traffic bit identity
# ---------------------------------------------------------------------------

def test_replica_kill_mid_traffic_is_bit_exact_vs_healthy_fleet():
    """replicas=2 fleet streaming delta frames, one replica killed by the
    fault plan at round 2: zero failed requests and scores bit-identical to
    a healthy single-replica fleet at every generation."""
    rng = np.random.default_rng(21)
    pipe = _pipe(21)
    plan = FaultPlan(kill_at={(0, 0): 2})
    router = _router(replicas=2, hedge_ms=5000, faults=plan)
    ref = _router(hedge_ms=5000)
    router.configure_fanout(pipe.sender.manifests, pipe.params)
    ref.configure_fanout(pipe.sender.manifests, pipe.params)
    reqs = _requests(np.random.default_rng(22))
    for rnd in range(1, 5):
        frames = pipe.run_round(iter([_mk_batch(rng)]))
        assert router.submit_updates(frames) == 2
        ref.submit_updates(frames)
        router.flush_updates()
        ref.flush_updates()
        assert np.array_equal(_scores(router, reqs), _scores(ref, reqs)), \
            f"round {rnd} bits moved"
        assert not router.stats.last_degraded
    assert plan.round == 4
    assert router.replica_generations()[0][0] is None  # the killed slot
    assert router.replica_generations()[0][1] == (4, 4)  # promoted sibling
    assert router.fleet_generations() == [(4, 4), (4, 4)]
    assert router.stats.degraded_responses == 0
    assert router.stats.failovers == 0  # promotion, not failover
    assert not router.degraded
    router.close()
    ref.close()


def test_injected_failures_fail_over_exactly_and_open_the_breaker(params):
    """A black-holed replica: reads fail over to the sibling with bit-exact
    scores, each attempt strikes the breaker, three strikes mark it dead."""
    plan = FaultPlan(fail_calls={(0, 0): -1})
    router = _router(params, replicas=2, hedge_ms=5000,
                     probe_interval_s=60.0, faults=plan)
    ref = _router(params)
    reqs = _requests(np.random.default_rng(23))
    want = _scores(ref, reqs)
    health = router._health[0][0]
    for _ in range(12):
        assert np.array_equal(_scores(router, reqs), want)
        if health.state == ReplicaHealth.DEAD:
            break
        time.sleep(0.12)  # let the suspect backoff lapse
    assert health.state == ReplicaHealth.DEAD
    assert router.stats.failovers >= health.max_strikes
    assert router.stats.degraded_responses == 0
    router.close()
    ref.close()


def test_straggler_is_hedged_to_sibling_first_response_wins(params):
    plan = FaultPlan(latency_s={(0, 0): 0.3})
    router = _router(params, replicas=2, hedge_ms=10_000, faults=plan)
    ref = _router(params)
    # default threshold: 3x p99 floored at 50 ms; cold stats sit on the floor
    assert ref._hedge_threshold_s() == pytest.approx(0.05)
    reqs = _requests(np.random.default_rng(24))
    want = _scores(ref, reqs)
    assert np.array_equal(_scores(router, reqs), want)
    router._rr = [0] * router.n_shards  # aim back at the slow replica
    router.hedge_ms = 40.0
    t0 = time.monotonic()
    got = _scores(router, reqs)
    elapsed = time.monotonic() - t0
    assert np.array_equal(got, want)
    assert router.stats.hedged_calls >= 1
    assert elapsed < 0.3  # did not wait out the straggler's spike
    assert not router.stats.last_degraded
    time.sleep(0.35)  # the loser finishes and releases its pool buffer
    assert np.array_equal(_scores(router, reqs), want)
    router.close()
    ref.close()


def test_deadline_gives_slices_up_as_flagged_zero_rows(params):
    plan = FaultPlan(latency_s={(0, 0): 0.3, (1, 0): 0.3})
    router = _router(params, faults=plan)
    ref = _router(params)
    reqs = _requests(np.random.default_rng(25))
    want = _scores(ref, reqs)
    assert np.array_equal(_scores(router, reqs), want)  # slow but exact
    outs = router.score_batch(reqs, deadline_ms=40.0)
    assert all(np.isfinite(o).all() for o in outs)
    assert router.stats.deadline_misses == 1
    assert router.stats.degraded_responses == 1
    assert router.stats.last_degraded
    assert np.array_equal(_scores(router, reqs), want)  # exact again
    assert not router.stats.last_degraded
    router.close()
    ref.close()


def test_prober_revives_dead_replica_once_the_fault_plan_exhausts(params):
    plan = FaultPlan(fail_calls={(0, 0): 2})  # first two calls fail, then ok
    router = _router(params, replicas=2, hedge_ms=5000,
                     probe_interval_s=0.02, faults=plan)
    health = router._health[0][0]
    health.backoff_s = 0.01
    now = time.monotonic()
    for _ in range(health.max_strikes):
        health.record_strike(now)
    assert health.state == ReplicaHealth.DEAD
    router._ensure_prober()
    deadline = time.monotonic() + 10.0
    while health.state != ReplicaHealth.HEALTHY:
        assert time.monotonic() < deadline, health.state
        time.sleep(0.01)
    ref = _router(params)
    reqs = _requests(np.random.default_rng(26))
    want = _scores(ref, reqs)
    for _ in range(2):  # both rotation slots: the revived replica serves
        assert np.array_equal(_scores(router, reqs), want)
    router.close()
    ref.close()


# ---------------------------------------------------------------------------
# Frame integrity: NACK + resync
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("action", [FRAME_DROP, FRAME_TRUNCATE, FRAME_BITFLIP])
def test_frame_fault_nacks_then_resync_restores_byte_exact_tables(action):
    rng = np.random.default_rng(31)
    pipe, clean = _pipe(31), _pipe(31)
    plan = FaultPlan(seed=5, frame_faults={(0, 1): action})  # 2nd frame out
    pipe.sender.faults = plan
    router = _router(replicas=2, hedge_ms=5000)
    ref = _router()
    router.configure_fanout(pipe.sender.manifests, pipe.params)
    ref.configure_fanout(clean.sender.manifests, clean.params)
    batch_rng = np.random.default_rng(32)
    clean_rng = np.random.default_rng(32)
    for _ in range(3):
        router.submit_updates(pipe.run_round(iter([_mk_batch(batch_rng)])))
        ref.submit_updates(clean.run_round(iter([_mk_batch(clean_rng)])))
    router.flush_updates()
    ref.flush_updates()
    # the faulted slice is stuck at generation 1 with its NACK latched
    assert router.fleet_generations()[0][0] == 1
    assert router.fleet_generations()[1][0] == 3
    errs = router.frame_errors()
    assert errs[0] is not None and errs[1] is None
    if action != FRAME_DROP:
        assert router._fleet[0][0]._pipe.stats.frames_rejected >= 1
        assert any(name in errs[0] for name in
                   ("TruncatedFrameError", "FrameChecksumError",
                    "VersionRegressionError", "FrameError"))
    assert np.isfinite(_scores(router, _requests(rng))).all()
    assert router.resync_shard(0, pipe.sender) == 2  # tee'd to both replicas
    router.flush_updates()
    assert router.frame_errors() == [None, None]
    assert all(g == (v, 3) for g, v in
               zip(router.fleet_generations(), (2, 3)))
    for rep in (0, 1):  # every replica of the slice healed byte-exact
        got, want = router._fleet[0][rep].params, ref.shards[0].params
        for key in ("codes", "scale", "zero"):
            assert torch.equal(got["ffm"]["emb"][key], want["ffm"]["emb"][key])
            assert torch.equal(got["lr"]["w"][key], want["lr"]["w"][key])
    reqs = _requests(np.random.default_rng(33))
    assert np.array_equal(_scores(router, reqs), _scores(ref, reqs))
    router.close()
    ref.close()


def test_poison_frame_does_not_kill_pipe_and_next_good_frame_applies(params):
    snd = transfer.Sender(mode="raw", device="cpu")
    u1 = snd.make_update(params)
    u2 = snd.make_update({k: ({kk: vv * 1.5 for kk, vv in v.items()}
                              if isinstance(v, dict) else v * 1.5)
                          for k, v in params.items()})
    eng = InferenceEngine(CFG, quantized=True, device="cpu")
    pipe = eng.update_pipe(snd.manifest, params)
    eng.submit_update(u1)
    assert pipe.flush() and eng.generation == 1
    eng.submit_update(u2[:len(u2) // 2])  # truncated mid-payload
    assert pipe.flush()  # drains: rejection is not a stall
    assert eng.generation == 1
    assert pipe.stats.frames_rejected == 1
    assert pipe.stats.last_frame_error.split(":")[0] in (
        "TruncatedFrameError", "FrameChecksumError", "FrameError")
    assert pipe._thread is not None and pipe._thread.is_alive()
    eng.submit_update(u2)  # base_version still matches: chain intact
    assert pipe.flush() and eng.generation == 2
    pipe.close()


# ---------------------------------------------------------------------------
# Pool exception safety / flush + kill / kill_shard edge cases
# ---------------------------------------------------------------------------

def test_all_replicas_failing_degrades_and_pool_stays_usable(params):
    plan = FaultPlan(fail_calls={(0, 0): -1})
    router = _router(params, probe_interval_s=60.0, faults=plan)
    reqs = _requests(np.random.default_rng(41))
    out1, out2 = _scores(router, reqs), _scores(router, reqs)
    assert np.isfinite(out1).all()
    assert np.array_equal(out1, out2)  # deterministic degraded responses
    assert router.stats.degraded_responses == 2
    assert router.stats.last_degraded
    n_cached = sum(len(v) for v in router._pool._buffers.values())
    assert n_cached <= 2 * router._pool.workers * len(router._pool._buffers)
    router.close()


def test_kill_shard_racing_flush_does_not_deadlock():
    pipe = _pipe(51)
    router = _router()
    router.configure_fanout(pipe.sender.manifests, pipe.params)
    frames = [pipe.run_round(iter([_mk_batch(np.random.default_rng(52))]))
              for _ in range(4)]
    router.submit_updates(frames[0])
    router.flush_updates()
    victim = router.shards[0]._pipe
    victim.faults = FaultPlan(ingest_sleep_s=0.25)
    for f in frames[1:]:
        router.submit_updates(f)
    assert victim.flush(timeout=0.05) is False
    # the other slice's frames land first, so that the flusher waits on the
    # victim's backlog alone (under load their ingest took seconds, which
    # the join below would have charged to the kill)
    assert router.shards[1]._pipe.flush(timeout=30.0)
    reached = threading.Event()  # the flusher is at the victim's flush
    flush = victim.flush

    def flush_and_signal(timeout=None):
        reached.set()
        return flush(timeout)

    victim.flush = flush_and_signal
    results = []
    flusher = threading.Thread(
        target=lambda: results.append(router.flush_updates(timeout=30.0)))
    flusher.start()
    assert reached.wait(timeout=30.0)
    router.kill_shard(0)  # kills the victim's pipe; must wake the flusher
    flusher.join(timeout=5.0)
    assert not flusher.is_alive(), "flush deadlocked behind kill_shard"
    assert len(results) == 1 and results[0][0] is None
    router.close()


def test_rotate_shard_racing_submit_and_flush_no_deadlock():
    """``rotate_shard``'s cross-object pair (``pipe._ingest_lock`` then
    ``succ._pipe_lock``) against concurrent submit + flush: no deadlock, the
    delta chain continues, and the witness sees no order violation."""
    pipe = _pipe(71)
    router, ref = _router(), _router()
    router.configure_fanout(pipe.sender.manifests, pipe.params)
    ref.configure_fanout(pipe.sender.manifests, pipe.params)
    rng = np.random.default_rng(72)
    frames = [pipe.run_round(iter([_mk_batch(rng)])) for _ in range(6)]
    router.submit_updates(frames[0])
    router.flush_updates()
    oks = []

    def traffic():
        for f in frames[1:]:
            router.submit_updates(f)
            oks.append(router.flush_updates(timeout=30.0))

    t = threading.Thread(target=traffic)
    t.start()
    for _ in range(3):
        router.rotate_shard(0)
        time.sleep(0.01)
    t.join(timeout=30.0)
    assert not t.is_alive(), "submit/flush deadlocked against rotate_shard"
    assert len(oks) == len(frames) - 1
    for f in frames:
        ref.submit_updates(f)
    ref.flush_updates()
    reqs = _requests(np.random.default_rng(73))
    np.testing.assert_array_equal(_scores(router, reqs), _scores(ref, reqs))
    router.close()
    ref.close()


def test_kill_shard_edge_cases_and_all_dead_degraded_serving(params):
    dup = _router(params, replicas=2, hedge_ms=5000)
    dup.kill_shard(0, 0)
    dup.kill_shard(0, 0)  # idempotent no-op
    assert not dup.degraded
    assert dup.replica_generations()[0][0] is None
    dup.close()

    router = _router(params)
    reqs = _requests(np.random.default_rng(61))
    before = _scores(router, reqs)
    router.kill_shard(0)
    router.kill_shard(0)  # double kill: no-op, stays latched degraded
    assert router.degraded
    with pytest.raises(ValueError, match="dead"):
        router.rotate_shard(0)
    router.kill_shard(1)  # the last live replica of the last live slice
    out = _scores(router, reqs)  # must not raise
    assert np.isfinite(out).all()
    assert not np.array_equal(out, before)
    assert router.stats.last_degraded and router.stats.degraded_responses >= 1
    assert router.fleet_generations() == [None, None]
    router.close()


# ---------------------------------------------------------------------------
# The fault plan and the witness themselves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("action", [FRAME_DROP, FRAME_TRUNCATE, FRAME_BITFLIP])
def test_fault_plan_schedule_matches_reference(action):
    """Same plan, same traffic: the same kills, call failures and frame
    corruption (byte and bit) as the JAX package's plan."""
    kw = dict(seed=7, kill_at={(1, 0): 2, (0, 1): 3},
              fail_calls={(0, 0): 2}, frame_faults={(1, 2): action})
    ours, theirs = FaultPlan(**kw), JFaultPlan(**kw)
    for _ in range(4):
        assert ours.next_round() == theirs.next_round()
    for _ in range(3):
        got = want = None
        try:
            ours.on_replica_call(0, 0)
        except FaultInjected as e:
            got = str(e)
        try:
            theirs.on_replica_call(0, 0)
        except RuntimeError as e:
            want = str(e)
        assert got == want
    frame = bytes(range(256)) * 3
    for _ in range(4):
        assert ours.corrupt_frame(1, frame) == theirs.corrupt_frame(1, frame)


def test_witness_wraps_the_port_locks_and_records_inversions(params):
    """The fixture's witness is live: the fleet's locks are witness locks
    under the reference names, and an inverted nesting is recorded."""
    router = _router(params)
    assert isinstance(router._fleet_lock, lw.WitnessLock)
    assert isinstance(router._lock, lw.WitnessLock)
    assert isinstance(router._pool._buf_lock, lw.WitnessLock)
    assert isinstance(router._health[0][0]._lock, lw.WitnessLock)
    assert router._fleet_lock._qual == "ShardRouter._fleet_lock"
    router.close()
    session = lw.Session()
    outer = lw.wrap(threading.Lock(), "InferenceEngine._lock", session)
    inner = lw.wrap(threading.Lock(), "ShardRouter._fleet_lock", session)
    with outer:
        with inner:
            pass
    assert len(session.violations) == 1
    assert session.violations[0].acquiring == "ShardRouter._fleet_lock"
