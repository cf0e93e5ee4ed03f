"""The port's sharded fleet against the JAX package on the CPU (the twin of
``tests/test_sharded_serving.py``, without its three host-gather tests).

* **Topology** — ``repro_torch.launch.topology`` gives the JAX package's
  ranges, owners and row-sharded paths; contiguous LR-block-aligned ranges
  make ``quantize(shard_slice(w)) == shard_slice(quantize(w))`` byte for
  byte, and shard tables concatenate back to the full tree.
* **Cross-N bit identity** — the port's router scores are bit-identical
  for every shard count N (int8 and f32 fleets, a non-divisible split),
  within the reference's router tolerance (atol 1e-5) of JAX's
  ``ShardRouter`` on the same weights and requests and of a single port
  engine; an entry's partial terms do not depend on the entry bucket, and
  the assembled view's per-shard row gathers equal one gather over the
  whole table.
* **Fan-out** — ``ShardedSender`` frames are byte-equal to JAX's for full
  and delta rounds and decode to exact slices of the full-space frames;
  the streamed fleet's int8 tables are byte-exact slices of a single
  engine fed the full-space frames.
* **Failure modes** — a killed shard degrades without raising, a torn
  generation vector serves, ``rotate_shard`` keeps the delta chain.

Every test runs under the port's lock-order witness.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import transfer as JT
from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as jdeepffm
from repro.launch import topology as jtopology
from repro.serving.shard_router import ShardRouter as JShardRouter
from repro_torch.checkpoint import layout, transfer
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import ffm
from repro_torch.core import quantization as Q
from repro_torch.launch import topology
from repro_torch.serving import shard_router as sr
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.shard_router import ShardRouter
from repro_torch.train.pipeline import TrainingPipeline

from _torch_lockcheck import torch_lock_witness  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_lock_witness")

CFG = FFMConfig(n_fields=8, context_fields=4, hash_space=2**12, k=4,
                mlp_hidden=(16, 8))
JCFG = JFFMConfig(**CFG.__dict__)
FC, FCAND = CFG.context_fields, CFG.n_fields - CFG.context_fields
ATOL = 1e-5  # the reference's router tolerance (test_sharded_serving.py)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree_util.tree_map(
        np.asarray, jdeepffm.init_params(JCFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def params(np_params):
    return params_from_numpy(np_params, "cpu")


def _router(params=None, **kw):
    return ShardRouter(CFG, params=params, device="cpu", **kw)


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


def _pipe(seed, n_shards=None):
    ranges = (None if n_shards is None
              else topology.shard_ranges(CFG.hash_space, n_shards))
    return TrainingPipeline(CFG, lr=0.05, seed=seed, device="cpu",
                            shard_ranges=ranges)


def _scores(eng, reqs):
    return np.concatenate(eng.score_batch(reqs))


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows,n_shards", [(1024, 3), (2**12, 4),
                                             (1000, 2), (2**12, 1)])
def test_shard_ranges_cover_aligned_and_match_reference(n_rows, n_shards):
    ranges = topology.shard_ranges(n_rows, n_shards)
    assert ranges == jtopology.shard_ranges(n_rows, n_shards)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_rows
    for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
        assert hi == lo
    for lo, _ in ranges:
        assert lo % Q.LR_BLOCK == 0
    owner = topology.owner_of(ranges, np.arange(n_rows))
    np.testing.assert_array_equal(
        owner, jtopology.owner_of(ranges, np.arange(n_rows)))
    for s, (lo, hi) in enumerate(ranges):
        assert (owner[lo:hi] == s).all()


def test_shard_ranges_too_many_shards():
    with pytest.raises(ValueError):
        topology.shard_ranges(128, 3)  # only 2 alignment units


@pytest.mark.parametrize("model", ["deepffm", "ffm", "mlp", "linear"])
def test_row_sharded_paths_from_specs(model):
    assert topology.row_sharded_paths(CFG, model) == \
        jtopology.row_sharded_paths(JCFG, model)
    if model == "deepffm":
        assert topology.row_sharded_paths(CFG) == ("ffm/emb", "lr/w")


def test_quantize_commutes_with_slicing(params):
    """quantize(shard_slice(w)) == shard_slice(quantize(w)) byte for byte."""
    topo = topology.ShardTopology.build(CFG, "deepffm", 3)
    full_q = Q.quantize_params_rows(params)
    for s in range(topo.n_shards):
        local_q = Q.quantize_params_rows(topo.shard_params(params, s))
        sliced = topo.shard_params(full_q, s)
        for key in ("codes", "scale", "zero"):
            assert torch.equal(local_q["ffm"]["emb"][key],
                               sliced["ffm"]["emb"][key])
            assert torch.equal(local_q["lr"]["w"][key], sliced["lr"]["w"][key])


def test_materialized_params_roundtrip(params):
    router = _router(params, n_shards=3, quantized=True)
    full_q = Q.quantize_params_rows(params)
    mat = router.materialized_params()
    router.close()
    for key in ("codes", "scale", "zero"):
        assert torch.equal(mat["ffm"]["emb"][key], full_q["ffm"]["emb"][key])
        assert torch.equal(mat["lr"]["w"][key], full_q["lr"]["w"][key])


# ---------------------------------------------------------------------------
# Cross-N bit identity + tolerance (the reduction contract)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [True, False])
def test_scores_bit_identical_across_shard_counts(params, np_params,
                                                  quantized):
    """N = 1..4 (3: a non-divisible split) bit-identical within the port,
    and each within the router tolerance of JAX's router at the same N."""
    reqs = _requests(np.random.default_rng(1))
    outs = {}
    for n in (1, 2, 3, 4):
        router = _router(params, n_shards=n, quantized=quantized)
        outs[n] = _scores(router, reqs)
        router.close()
    for n in (2, 3, 4):
        assert np.array_equal(outs[n], outs[1]), f"N={n} bits != N=1"
    for n in (1, 2, 4):
        jrouter = JShardRouter(JCFG, n_shards=n, params=np_params,
                               quantized=quantized)
        want = np.concatenate([np.asarray(o)
                               for o in jrouter.score_batch(reqs)])
        jrouter.close()
        np.testing.assert_allclose(outs[n], want, atol=ATOL,
                                   err_msg=f"N={n}")


def test_router_within_tolerance_of_forward_oracle(params):
    reqs = _requests(np.random.default_rng(2))
    router = _router(params, n_shards=2, quantized=False)
    got = _scores(router, reqs)
    want = np.concatenate([router.score_uncached(*r).numpy() for r in reqs])
    router.close()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_quantized_router_matches_single_quantized_engine(params):
    reqs = _requests(np.random.default_rng(3))
    router = _router(params, n_shards=2, quantized=True)
    single = InferenceEngine(CFG, params=params, quantized=True, device="cpu")
    got = _scores(router, reqs)
    want = _scores(single, reqs)
    router.close()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_resident_bytes_split_across_shards(params):
    single = InferenceEngine(CFG, params=params, quantized=True, device="cpu")
    router = _router(params, n_shards=4, quantized=True)
    per_shard = router.shard_resident_bytes()
    assert max(per_shard) < single.resident_weight_bytes / 2
    assert sum(per_shard) == router.resident_weight_bytes
    router.close()


@pytest.mark.parametrize("quantized", [True, False])
def test_partial_terms_invariant_to_entry_bucket(params, quantized):
    """An entry's partial terms and rows are the same bits at buckets 8 and
    64 (what keeps the router's output independent of how entries spread
    over shards)."""
    table = (Q.quantize_params_rows(params)["ffm"]["emb"] if quantized
             else params["ffm"]["emb"])
    rng = np.random.default_rng(4)
    m = 5
    local = torch.from_numpy(rng.integers(0, CFG.hash_space, m)
                             .astype(np.int32))
    a_ctx = torch.from_numpy(rng.standard_normal((m, FC, CFG.k))
                             .astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((m, FC)).astype(np.float32))
    vm = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    outs = []
    for mb in (8, 64):
        def pad(x):
            return torch.cat([x, x.new_zeros((mb - m,) + tuple(x.shape[1:]))])

        buf = torch.empty((mb, CFG.n_fields, CFG.k))
        if quantized:
            terms, rows = sr._shard_partial_q8(CFG, pad(a_ctx), pad(vc),
                                               pad(vm), table, local, buf)
        else:
            buf[:m] = table[local]
            buf[m:] = 0
            terms, rows = sr._shard_partial_rows(CFG, pad(a_ctx), pad(vc),
                                                 pad(vm), buf)
        outs.append((terms[:m].clone(), rows[:m].clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    # the fixed-order chain is the plain product-sum, up to rounding
    rows = ffm.gather_rows(table, local)
    want = torch.einsum("mik,mik->mi", a_ctx, rows[:, :FC]) * vc * vm[:, None]
    torch.testing.assert_close(outs[0][0], want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("quantized", [True, False])
def test_assembled_view_gathers_equal_whole_table(params, quantized):
    """ShardedRows / ShardedLR gather per owning shard into disjoint rows:
    bit-equal to one gather over the whole table; dead shards give zeros."""
    full = Q.quantize_params_rows(params) if quantized else params
    topo = topology.ShardTopology.build(CFG, "deepffm", 3)
    parts = [topo.shard_params(full, s) for s in range(3)]
    rows = sr.ShardedRows([p["ffm"]["emb"] for p in parts], topo.ranges,
                          (CFG.n_fields, CFG.k), torch.device("cpu"))
    lr = sr.ShardedLR([p["lr"]["w"] for p in parts], topo.ranges,
                      torch.device("cpu"))
    idx = torch.from_numpy(np.random.default_rng(5).integers(
        0, CFG.hash_space, (6, 4)).astype(np.int32))
    assert torch.equal(ffm.gather_rows(rows, idx),
                       ffm.gather_rows(full["ffm"]["emb"], idx))
    assert torch.equal(ffm.gather_lr(lr, idx),
                       ffm.gather_lr(full["lr"]["w"], idx).float())
    rows.parts[1] = None
    got = ffm.gather_rows(rows, idx)
    dead = torch.from_numpy(topo.owner_of(idx.numpy()) == 1)
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    assert torch.equal(got[~dead],
                       ffm.gather_rows(full["ffm"]["emb"], idx)[~dead])


# ---------------------------------------------------------------------------
# Fan-out frames
# ---------------------------------------------------------------------------

def _param_rounds(np_params, n_rounds=3):
    """A params sequence with per-round touched rows (full, then deltas)."""
    rng = np.random.default_rng(6)
    cur = jax.tree_util.tree_map(np.copy, np_params)
    out = []
    for _ in range(n_rounds):
        rows = np.unique(rng.integers(0, CFG.hash_space, 40))
        cur = jax.tree_util.tree_map(np.copy, cur)
        cur["ffm"]["emb"][rows] += rng.normal(
            0, 0.01, cur["ffm"]["emb"][rows].shape).astype(np.float32)
        cur["lr"]["w"][rows] += rng.normal(0, 0.01, rows.size).astype(
            np.float32)
        cur["mlp"]["w0"] += np.float32(1e-3)
        out.append((cur, {"ffm/emb": rows, "lr/w": rows}))
    return out


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_sharded_sender_frames_byte_equal_to_reference(np_params, n_shards):
    ranges = topology.shard_ranges(CFG.hash_space, n_shards)
    paths = topology.row_sharded_paths(CFG)
    ours = transfer.ShardedSender(ranges=ranges, row_paths=paths,
                                  device="cpu")
    theirs = JT.ShardedSender(ranges=ranges, row_paths=paths)
    ours.prime(params_from_numpy(np_params, "cpu"))
    theirs.prime(np_params)
    assert ours.manifests == theirs.manifests
    kinds = []
    for v, (p, touched) in enumerate(_param_rounds(np_params), start=1):
        got = ours.make_updates(params_from_numpy(p, "cpu"), version=v,
                                touched=touched if v > 1 else None)
        want = theirs.make_updates(p, version=v,
                                   touched=touched if v > 1 else None)
        assert got == want, f"round {v}"
        kinds.append(transfer.unframe(got[0]).kind)
    assert kinds[0] == transfer.KIND_FULL
    assert transfer.KIND_DELTA in kinds[1:]
    for s in range(n_shards):
        assert ours.resync(s) == theirs.resync(s)


def test_sharded_frames_decode_to_slices_of_full_frames():
    """Per-shard delta filtering against the full-space ingest, byte for
    byte, at every generation while deltas stream."""
    rng = np.random.default_rng(7)
    ranges = topology.shard_ranges(CFG.hash_space, 2)
    pipe_s, pipe_f = _pipe(3, 2), _pipe(3)
    rec_full = transfer.Receiver(device="cpu")
    recs = [transfer.Receiver(device="cpu") for _ in ranges]
    kinds = []
    for rnd in range(3):
        batch = [_mk_batch(rng)]
        frames = pipe_s.run_round(iter(batch))
        full = pipe_f.run_round(iter(batch))
        kinds.append(transfer.unframe(full).kind)
        assert [transfer.unframe(f).kind for f in frames] == \
            [transfer.unframe(full).kind] * len(ranges)  # grid coherence
        rec_full.apply_update(full)
        want = dict(rec_full.materialize(manifest=pipe_f.sender.manifest))
        for s, (frame, rec) in enumerate(zip(frames, recs)):
            rec.apply_update(frame)
            assert rec.version == transfer.unframe(full).version
            got = rec.materialize(manifest=pipe_s.sender.manifests[s])
            lo, hi = ranges[s]
            for path, arr in got.items():
                ref = want[path]
                if path in ("ffm/emb", "lr/w"):
                    ref = ref[lo:hi]
                assert torch.equal(ref, arr), f"round {rnd} shard {s} {path}"
    assert kinds[0] == transfer.KIND_FULL
    assert transfer.KIND_DELTA in kinds[1:]


def test_streamed_fleet_matches_single_engine_ingest():
    """The contract of the reference test of this name: full + delta rounds
    streamed through per-shard pipes leave the fleet's int8 tables
    byte-exact slices of a single engine fed the full-space frames, the
    generation vector advances, and the scores agree within tolerance."""
    rng = np.random.default_rng(8)
    ranges = topology.shard_ranges(CFG.hash_space, 2)
    pipe_s, pipe_f = _pipe(4, 2), _pipe(4)
    router = _router(n_shards=2, quantized=True)
    single = InferenceEngine(CFG, quantized=True, device="cpu")
    rounds = []
    for _ in range(3):
        batch = [_mk_batch(rng)]
        rounds.append((pipe_s.run_round(iter(batch)),
                       pipe_f.run_round(iter(batch))))
    router.configure_fanout(pipe_s.sender.manifests, pipe_f.params)
    for frames, full in rounds:
        assert router.submit_updates(frames) == 2
        single.submit_update(full, manifest=pipe_f.sender.manifest,
                             like_params=pipe_f.params)
    gens = router.flush_updates()
    assert single.update_pipe().flush()
    assert all(g == (3, 3) for g in gens)
    assert router.weights_version == 3
    sp = single.params
    for s, shard in enumerate(router.shards):
        lo, hi = ranges[s]
        for key in ("codes", "scale", "zero"):
            assert torch.equal(shard.params["ffm"]["emb"][key],
                               sp["ffm"]["emb"][key][lo:hi])
        for key in ("codes", "scale", "zero"):
            b = Q.LR_BLOCK
            want = (sp["lr"]["w"][key][lo:hi] if key == "codes"
                    else sp["lr"]["w"][key][lo // b: -(-hi // b)])
            assert torch.equal(shard.params["lr"]["w"][key], want)
    reqs = _requests(rng)
    got, want = _scores(router, reqs), _scores(single, reqs)
    router.close()
    single.update_pipe().close()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_streamed_bits_invariant_across_shard_counts():
    """N = 2 streamed fleet == N = 1 streamed fleet bit for bit at the final
    generation (the reduction contract holds for ingested weights too)."""
    outs = {}
    for n in (1, 2):
        pipe = _pipe(5, n)
        router = _router(n_shards=n, quantized=True)
        batch_rng = np.random.default_rng(10)  # same batches for both fleets
        frames = [pipe.run_round(iter([_mk_batch(batch_rng)]))
                  for _ in range(2)]
        router.configure_fanout(pipe.sender.manifests, pipe.params)
        for f in frames:
            router.submit_updates(f)
        router.flush_updates()
        outs[n] = _scores(router, _requests(np.random.default_rng(11)))
        router.close()
    assert np.array_equal(outs[2], outs[1])


# ---------------------------------------------------------------------------
# Failure modes
# ---------------------------------------------------------------------------

def test_kill_shard_degrades_gracefully(params):
    reqs = _requests(np.random.default_rng(12))
    router = _router(params, n_shards=3, quantized=True)
    before = _scores(router, reqs)
    router.kill_shard(1)
    assert router.degraded
    after = _scores(router, reqs)  # must not raise
    assert np.isfinite(after).all()
    assert not np.array_equal(before, after)  # the dead rows really zeroed
    assert router.fleet_generations()[1] is None
    assert router.stats.last_degraded
    # the oracle still works against the zero-filled materialized tables
    assert torch.isfinite(router.score_uncached(*reqs[0])).all()
    router.close()


def test_torn_generation_vector_serves():
    """One shard a generation ahead of the other: the router serves the
    mixed snapshot, and converges once both shards flush."""
    rng = np.random.default_rng(13)
    pipe = _pipe(6, 2)
    router = _router(n_shards=2, quantized=True)
    f0 = pipe.run_round(iter([_mk_batch(rng)]))
    f1 = pipe.run_round(iter([_mk_batch(rng)]))
    router.configure_fanout(pipe.sender.manifests, pipe.params)
    router.submit_updates(f0)
    router.flush_updates()
    router.shards[0].submit_update(f1[0])  # tear: only shard 0 gets round 2
    assert router.shards[0]._pipe.flush()
    gens = router.fleet_generations()
    assert gens[0][1] == 2 and gens[1][1] == 1
    reqs = _requests(rng)
    assert np.isfinite(_scores(router, reqs)).all()
    router.shards[1].submit_update(f1[1])
    router.flush_updates()
    assert all(g[1] == 2 for g in router.fleet_generations())
    healed = _scores(router, reqs)
    other = _router(n_shards=2, quantized=True)
    other.configure_fanout(pipe.sender.manifests, pipe.params)
    for f in (f0, f1):
        other.submit_updates(f)
    other.flush_updates()
    assert np.array_equal(healed, _scores(other, reqs))
    router.close()
    other.close()


def test_rotate_shard_swaps_successor_and_keeps_delta_chain():
    rng = np.random.default_rng(14)
    pipe = _pipe(7, 2)
    router = _router(n_shards=2, quantized=True)
    f0 = pipe.run_round(iter([_mk_batch(rng)]))
    router.configure_fanout(pipe.sender.manifests, pipe.params)
    router.submit_updates(f0)
    router.flush_updates()
    reqs = _requests(rng)
    before = _scores(router, reqs)
    old = router.shards[0]
    succ = router.rotate_shard(0)
    assert router.shards[0] is succ and succ is not old
    assert succ.generation >= old.generation  # monotonic across the swap
    assert np.array_equal(_scores(router, reqs), before)
    f1 = pipe.run_round(iter([_mk_batch(rng)]))
    assert transfer.unframe(f1[0]).kind == transfer.KIND_DELTA
    router.submit_updates(f1)
    router.flush_updates()
    assert succ.weights_version == 2
    assert np.isfinite(_scores(router, reqs)).all()
    router.close()


def test_engine_rotate_adopts_params_and_version(params):
    eng = InferenceEngine(CFG, params=params, quantized=True, device="cpu",
                          warmup_buckets=(2, 8))
    reqs = _requests(np.random.default_rng(15))
    want = _scores(eng, reqs)
    succ = eng.rotate()
    assert succ.params is eng.params  # adopted by reference
    assert succ.generation == eng.generation
    assert succ.weights_version == eng.weights_version
    assert succ._warmed_buckets == (2, 8)
    assert np.array_equal(_scores(succ, reqs), want)


def test_suggest_checkpoint_depths_follows_traffic(params):
    """Depths that traffic reuses survive, the full depth always; with no
    intermediate reuse the current set stays (the reference's rule)."""
    eng = InferenceEngine(CFG, params=params, quantized=True, device="cpu",
                          prefix_stride=1)
    assert eng.suggest_checkpoint_depths() == [1, 2, 3, 4]
    rng = np.random.default_rng(16)
    shared = rng.integers(0, CFG.hash_space, FC).astype(np.int32)
    for i in range(6):  # contexts sharing their first two fields
        ci = shared.copy()
        ci[2:] = rng.integers(0, CFG.hash_space, FC - 2)
        eng.score(ci, np.ones(FC, np.float32),
                  rng.integers(0, CFG.hash_space, (3, FCAND)).astype(np.int32),
                  np.ones((3, FCAND), np.float32))
    assert eng.prefix_hit_depths[2] == 5
    assert eng.suggest_checkpoint_depths() == [2, 4]
