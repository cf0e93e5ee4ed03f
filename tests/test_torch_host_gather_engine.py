"""The port's host-gather engine (``InferenceEngine(host_gather=True)``) on
the CPU, against the JAX package's and its own device-gather twin.

* twins of ``test_quantized_serving.py``'s
  ``test_host_gather_engine_matches_roundtrip_oracle`` (both backends,
  rtol 2e-4 / atol 2e-5) and ``test_host_gather_batch_dedup_matches_
  in_trace_engine`` (rtol 1e-6 / atol 1e-7), ``test_sharded_serving.py``'s
  ``test_f32_host_gather_parity`` and ``test_fused_scoring.py``'s
  ``test_fused_auto_selection_respects_pinned_strategies``, whose one
  assertion on ``fused=True`` holds the port's design instead: a forced
  fused engine keeps the device gather;
* host-gather engines bit for bit as their device-gather twins (the LR
  terms summed on the device);
* the port's host-gather engines against JAX's host-gather engines on the
  same weights (through ``convert``);
* bit parity across ``parallel`` 1 / 2 / 4 with the pool's host buffers;
* ``_compact_grids`` byte for byte against JAX's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as jdeepffm
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import deepffm
from repro_torch.core import quantization as Q
from repro_torch.kernels.row_gather import ops as rg_ops
from repro_torch.serving.engine import InferenceEngine

CFG = FFMConfig(n_fields=12, context_fields=8, hash_space=2**13, k=4,
                mlp_hidden=(16,))
JCFG = JFFMConfig(**CFG.__dict__)
FC, FCAND = CFG.context_fields, CFG.n_fields - CFG.context_fields


@pytest.fixture(autouse=True)
def _pinned_gather_cliff(monkeypatch):
    # the JAX package's host gather consults a per-process calibration probe;
    # pin its constant so the reference runs no probe
    monkeypatch.setenv("REPRO_CLIFF_CALIBRATE", "0")


def _np_params(model="deepffm", seed=0):
    params = jax.tree_util.tree_map(np.asarray, jdeepffm.init_params(
        JCFG, jax.random.PRNGKey(seed), model))
    params["lr"]["w"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed + 1), params["lr"]["w"].shape)) * 0.1
    return params


def _req(rng, n_cand, ctx=None):
    ci, cv = ctx if ctx is not None else (
        rng.integers(0, CFG.hash_space, FC).astype(np.int32),
        rng.normal(1, 0.25, FC).astype(np.float32))
    return (ci, cv,
            rng.integers(0, CFG.hash_space, (n_cand, FCAND)).astype(np.int32),
            rng.normal(1, 0.25, (n_cand, FCAND)).astype(np.float32))


def _traffic(seed, sizes=(2, 7, 4, 13, 1)):
    rng = np.random.default_rng(seed)
    reqs = [_req(rng, n) for n in sizes]
    reqs.append(reqs[0])  # a repeat: dedup across requests
    reqs.append(_req(rng, 5, ctx=reqs[1][:2]))  # a shared context
    reqs.append(_req(rng, 0))  # an empty slate
    return reqs


def _engine(params, model="deepffm", **kw):
    kw.setdefault("device", "cpu")
    return InferenceEngine(CFG, model, params=params_from_numpy(params, "cpu"),
                           **kw)


def _roundtrip_params(params, qparams):
    """f32 params whose emb / LR tables are the engine's dequantized int8
    tables: the exact oracle of the quantized path."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    out["ffm"]["emb"] = Q.dequantize_rows(qparams["ffm"]["emb"])
    out["lr"]["w"] = Q.dequantize_blocks(qparams["lr"]["w"])
    return out


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_host_gather_engine_matches_roundtrip_oracle(backend):
    """``host_gather=True`` forces the packed pre-gather + q8 forward on a
    small table; it matches the roundtrip oracle like the device gather
    (on CPU tensors the ``"cuda"`` backend's kernels run their plain
    versions)."""
    params = _np_params()
    qe = _engine(params, backend=backend, quantized=True, host_gather=True,
                 warmup_buckets=(4, 16))
    assert qe.host_gather and not qe.fused
    rt = _engine(_roundtrip_params(params, qe.params), backend=backend)
    rng = np.random.default_rng(6)
    for n in (1, 5, 8, 16):
        req = _req(rng, n)
        np.testing.assert_allclose(qe.score(*req), rt.score(*req),
                                   rtol=2e-4, atol=2e-5)


def test_host_gather_batch_dedup_matches_in_trace_engine():
    """Same quantized tables, two gather strategies: host pre-gather and
    device gather agree on batched, deduped traffic (the strategies move
    the same bytes)."""
    params = _np_params("ffm")
    host = _engine(params, "ffm", quantized=True, host_gather=True,
                   prefix_stride=2)
    trace = _engine(params, "ffm", quantized=True, host_gather=False,
                    prefix_stride=2)
    assert host.host_gather and not trace.host_gather
    assert not host.fused and not trace.fused
    reqs = _traffic(8)
    for got, want in zip(host.score_batch(reqs), trace.score_batch(reqs)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_f32_host_gather_parity():
    """An f32 engine forced onto the host packed pre-gather scores like the
    device-gather one."""
    params = _np_params()
    reqs = _traffic(16)
    host = _engine(params, host_gather=True)
    trace = _engine(params, host_gather=False)
    assert host.host_gather and not trace.host_gather
    got = np.concatenate(host.score_batch(reqs))
    want = np.concatenate(trace.score_batch(reqs))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fused_auto_selection_respects_pinned_strategies():
    """Auto-fused activates only where the host-gather policy itself was
    auto: pinning ``host_gather`` (either way) or a non-ffm head keeps the
    engine staged, and ``fused=True`` on a non-ffm head refuses loudly.
    The port's one difference: ``fused=True`` keeps the device gather."""
    params = _np_params("ffm")
    assert not _engine(params, "ffm", quantized=True, host_gather=True).fused
    assert not _engine(params, "ffm", quantized=True, host_gather=False).fused
    auto = _engine(params, "ffm", quantized=True)
    assert auto.fused == auto.host_gather == rg_ops.use_host_gather(
        CFG.hash_space, "cpu")
    # f32 engines and deepffm heads never auto-fuse
    assert not _engine(params, "ffm").fused
    deep = _np_params()
    assert not _engine(deep, quantized=True).fused
    with pytest.raises(ValueError):
        _engine(deep, quantized=True, fused=True)
    # explicit fused does not force the host pre-gather (ROADMAP.md Queue 3)
    forced = _engine(params, "ffm", quantized=True, fused=True)
    assert forced.fused and not forced.host_gather
    # past the cliff the auto policy picks both, as JAX's does
    big = FFMConfig(n_fields=4, context_fields=2, hash_space=rg_ops.CLIFF_ROWS,
                    k=2, mlp_hidden=(4,))
    p = deepffm.init_params(big, 0, "ffm", "cpu")
    past = InferenceEngine(big, "ffm", params=p, device="cpu", quantized=True)
    assert past.host_gather and past.fused
    pinned = InferenceEngine(big, "ffm", params=p, device="cpu",
                             quantized=True, host_gather=True)
    assert pinned.host_gather and not pinned.fused


@pytest.mark.parametrize("model,quantized,fused", [
    ("deepffm", True, False), ("deepffm", False, False),
    ("ffm", True, True), ("ffm", False, True)])
def test_host_gather_scores_bit_for_bit_as_the_device_twin(model, quantized,
                                                           fused):
    """The port sums the uploaded LR terms on the device, by the reduction
    the device gather uses, so the host-gather engine's scores equal its
    device-gather twin's bit for bit (JAX holds the pair to 1e-6 / 1e-7)."""
    params = _np_params(model, seed=9)
    host, twin = (_engine(params, model, quantized=quantized, fused=fused,
                          host_gather=h) for h in (True, False))
    reqs = _traffic(12)
    for _ in range(2):  # cold, then from the prefix cache
        for got, want in zip(host.score_batch(reqs), twin.score_batch(reqs)):
            assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("model,quantized,fused", [
    ("deepffm", True, False), ("deepffm", False, False),
    ("ffm", True, True), ("ffm", False, True)])
def test_port_host_gather_engine_matches_jax(model, quantized, fused):
    """The port's and JAX's host-gather engines on the same weights:
    identical int8 tables, scores at the engines' tolerance."""
    params = _np_params(model, seed=3)
    kw = dict(quantized=quantized, host_gather=True, fused=fused,
              prefix_stride=4)
    ours = _engine(params, model, **kw)
    ref = JEngine(JCFG, model, backend="pallas" if fused else "reference",
                  params=params, **kw)
    assert ours.host_gather and ref.host_gather
    if quantized:
        for key in ("codes", "scale", "zero"):
            assert np.asarray(ours.params["ffm"]["emb"][key]).tobytes() == \
                np.asarray(ref.params["ffm"]["emb"][key]).tobytes()
    reqs = _traffic(11)
    for got, want in zip(ours.score_batch(reqs), ref.score_batch(reqs)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-5)
    assert ours.stats.rows_scored == ref.stats.rows_scored


@pytest.mark.parametrize("model,quantized,fused", [
    ("deepffm", True, False), ("deepffm", False, False), ("ffm", True, True)])
def test_parallel_bit_parity_with_pooled_host_buffers(model, quantized, fused):
    """Spans at ``parallel`` 1 / 2 / 4 through the pool, host gathers into
    recycled buffers, give bit-identical scores, batch after batch."""
    params = _np_params(model, seed=4)
    engines = [_engine(params, model, quantized=quantized, fused=fused,
                       host_gather=True, parallel=n) for n in (1, 2, 4)]
    rng = np.random.default_rng(2)
    for _ in range(2):
        reqs = [_req(rng, n) for n in (9, 3, 16, 1, 7, 12, 5, 2)]
        outs = [e.score_batch(reqs) for e in engines]
        for other in outs[1:]:
            for a, b in zip(outs[0], other):
                assert a.tobytes() == b.tobytes()
    pool = engines[2]._scoring_pool
    assert pool is not None and pool._buffers  # the buffers came back
    for e in engines:
        e.close()


def test_compact_grids_match_jax():
    params = _np_params(seed=5)
    ours = _engine(params, quantized=True, host_gather=True)
    ref = JEngine(JCFG, params=params, quantized=True, host_gather=True)
    rng = np.random.default_rng(7)
    n_rows, n_chunks, nb = 23, 4, 8
    ki_u = rng.integers(0, CFG.hash_space, (n_rows, FCAND)).astype(np.int32)
    slots = rng.permutation(n_chunks * nb)[:n_rows]
    row_of_u, slot_of_u = slots // nb, slots % nb
    got = ours._compact_grids(ours.params, ki_u, row_of_u, slot_of_u,
                              n_chunks, nb, FCAND)
    want = ref._compact_grids(ref.params, ki_u, row_of_u, slot_of_u,
                              n_chunks, nb, FCAND)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    # engines whose forward takes no host grids
    for eng in (_engine(params, host_gather=True),
                _engine(params, quantized=True, host_gather=False)):
        assert eng._compact_grids(eng.params, ki_u, row_of_u, slot_of_u,
                                  n_chunks, nb, FCAND) is None


def test_host_mirror_built_once_per_published_params():
    """The host mirror is built on the first use and again per publish, two
    slots deep (the published and the standby generation)."""
    params = _np_params()
    eng = _engine(params, quantized=True, host_gather=True)
    reqs = _traffic(3)
    eng.score_batch(reqs)
    eng.score_batch(reqs)
    assert eng.host_mirror_builds == 1 and eng.host_mirror_ms >= 0.0
    emb_h, _ = eng._host_weights(eng.params)
    # zero-copy on the CPU: the mirror is the engine's table
    codes = eng.params["ffm"]["emb"]["codes"]
    assert emb_h["codes"].ctypes.data == codes.data_ptr()
    first = eng.params
    eng._publish(params_from_numpy(params, "cpu"), 2, 0)
    assert eng.host_mirror_builds == 2
    eng.score_batch(reqs)
    assert eng.host_mirror_builds == 2
    eng._host_weights(first)  # still in the standby slot
    assert eng.host_mirror_builds == 2
    assert isinstance(eng.params["ffm"]["emb"]["codes"], torch.Tensor)
