"""The port's serving roofline and the kernels' bookings on the CPU.

* ``InferenceEngine.host_gather_bytes`` equals JAX's for int8 / f32 tables,
  host gather on / off and ``unique_rows``;
* ``ServingRoofline``'s properties equal JAX's on the same numbers (the
  port's ``counted_*`` fields are JAX's ``hlo_*``), and its one field JAX
  lacks, ``host_bandwidth_bytes_per_s``, splits the bound as documented;
* each of K1-K6 books its ``k*_work`` at the main path's shapes
  (``FFMConfig()``, one (8, 64) bucket), and an op counter over a wrapper
  reads its booking and nothing else;
* ``serving_roofline`` on a CPU engine counts exactly the forward that
  ``_candidates_forward`` runs.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as jdeepffm
from repro.launch.roofline import ServingRoofline as JServingRoofline
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ffm_interaction import ops as fi_ops
from repro_torch.kernels.row_gather import ops as rg_ops
from repro_torch.launch import op_analysis
from repro_torch.launch.roofline import (ServingRoofline,
                                         measure_cpu_bandwidth,
                                         serving_roofline)
from repro_torch.serving.engine import InferenceEngine

CFG = FFMConfig(n_fields=8, context_fields=5, hash_space=2**10, k=4,
                mlp_hidden=(16, 8))
JCFG = JFFMConfig(**CFG.__dict__)


@pytest.fixture(autouse=True)
def _pinned_gather_cliff(monkeypatch):
    monkeypatch.setenv("REPRO_CLIFF_CALIBRATE", "0")


def _np_params(model="deepffm", seed=0):
    return jax.tree_util.tree_map(np.asarray, jdeepffm.init_params(
        JCFG, jax.random.PRNGKey(seed), model))


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("host", [True, False])
def test_host_gather_bytes_match_jax(quantized, host):
    params = _np_params()
    ours = InferenceEngine(CFG, params=params_from_numpy(params, "cpu"),
                           device="cpu", quantized=quantized, host_gather=host)
    ref = JEngine(JCFG, params=params, quantized=quantized, host_gather=host)
    for rb, nb in ((1, 8), (8, 64), (4, 16)):
        for unique in (None, 0, 3, rb * nb):
            got = ours.host_gather_bytes(rb, nb, unique_rows=unique)
            assert got == ref.host_gather_bytes(rb, nb, unique_rows=unique)
            assert (got == 0) == (not host)


NUMBERS = [
    dict(scenario="a", predictions_per_call=512, bytes_=1.5e6,
         host_bytes=2.5e5, flops=8e5, measured=3.1e5, bw=2.9e12,
         streams=1, agg_bw=None, agg_measured=None),
    dict(scenario="b", predictions_per_call=96, bytes_=7.25e4,
         host_bytes=0.0, flops=1e3, measured=1.7e7, bw=1.1e10,
         streams=4, agg_bw=2.7e10, agg_measured=4.4e7),
]


def _pair(n, **extra):
    ours = ServingRoofline(
        scenario=n["scenario"], predictions_per_call=n["predictions_per_call"],
        counted_bytes_per_call=n["bytes_"], host_bytes_per_call=n["host_bytes"],
        counted_flops_per_call=n["flops"], measured_preds_per_s=n["measured"],
        bandwidth_bytes_per_s=n["bw"], streams=n["streams"],
        aggregate_bandwidth_bytes_per_s=n["agg_bw"],
        aggregate_measured_preds_per_s=n["agg_measured"], **extra)
    ref = JServingRoofline(
        scenario=n["scenario"], predictions_per_call=n["predictions_per_call"],
        hlo_bytes_per_call=n["bytes_"], host_bytes_per_call=n["host_bytes"],
        hlo_flops_per_call=n["flops"], measured_preds_per_s=n["measured"],
        bandwidth_bytes_per_s=n["bw"], streams=n["streams"],
        aggregate_bandwidth_bytes_per_s=n["agg_bw"],
        aggregate_measured_preds_per_s=n["agg_measured"])
    return ours, ref


PROPS = ("bytes_per_prediction", "bound_preds_per_s", "fraction_of_bound",
         "aggregate_bound_preds_per_s", "aggregate_fraction_of_bound")


@pytest.mark.parametrize("n", NUMBERS, ids=[n["scenario"] for n in NUMBERS])
def test_serving_roofline_properties_match_jax(n):
    ours, ref = _pair(n)
    for prop in PROPS:
        assert getattr(ours, prop) == getattr(ref, prop), prop
    d_ours, d_ref = ours.to_dict(), ref.to_dict()
    for prop in PROPS:
        assert d_ours[prop] == d_ref[prop]
    assert d_ours["counted_bytes_per_call"] == d_ref["hlo_bytes_per_call"]
    # a host bandwidth equal to the device's: JAX's bound, up to rounding
    # (the aggregate bandwidth then stands for the host's alone)
    same, _ = _pair(n, host_bandwidth_bytes_per_s=n["bw"])
    for prop in PROPS[:3]:
        assert math.isclose(getattr(same, prop), getattr(ref, prop),
                            rel_tol=1e-12)
    # two bandwidths: each byte stream over its own memory
    split, _ = _pair(n, host_bandwidth_bytes_per_s=n["bw"] / 10)
    per = n["predictions_per_call"]
    want = 1.0 / (n["bytes_"] / per / n["bw"]
                  + n["host_bytes"] / per / (n["bw"] / 10))
    assert math.isclose(split.bound_preds_per_s, want, rel_tol=1e-12)
    assert math.isclose(split.fraction_of_bound, n["measured"] / want,
                        rel_tol=1e-12)


def test_measure_cpu_bandwidth_is_positive():
    assert measure_cpu_bandwidth(nbytes=1 << 20, repeats=2) > 0
    assert measure_cpu_bandwidth(nbytes=1 << 20, repeats=1, streams=2) > 0


# the main path's widths (FFMConfig()) at one (8, 64) bucket
R, N, FC, FCAND, K = 8, 64, 16, 8, 8
F = FC + FCAND


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _kernel_cases():
    rng = np.random.default_rng(0)

    def randn(*shape):
        return _t(rng.normal(0, 0.1, shape).astype(np.float32))

    def codes(*shape):
        return _t(rng.integers(-127, 128, shape).astype(np.int8))

    v = 1000
    table = (codes(v, F, K), _t(rng.uniform(1e-4, 1e-2, v).astype(np.float32)),
             randn(v))
    idx = _t(rng.integers(0, v, (N, F)).astype(np.int32))
    ectx, vctx = randn(R, FC, F, K), randn(R, FC)
    vcand = randn(R, N, FCAND)
    ec, qc = randn(R, N, FCAND, F, K), codes(R, N, FCAND, F, K)
    grid = (randn(R, N, FCAND), randn(R, N, FCAND))
    depth = _t(rng.integers(0, FC + 1, R).astype(np.int32))
    base = randn(R, N)
    return {
        "gather_dequant_rows_q8": (
            lambda: rg_ops.gather_dequant_rows_q8(*table, idx),
            rg_ops.k1_work(N * F, F * K)),
        "ffm_candidate_matrices": (
            lambda: fi_ops.ffm_candidate_matrices(
                ectx[:, :, FC:], vctx, ec[..., :FC, :], ec[..., FC:, :],
                vcand),
            fi_ops.k2_work(R, N, FC, FCAND, K)),
        "ffm_candidate_matrices_q8": (
            lambda: fi_ops.ffm_candidate_matrices_q8(
                ectx[:, :, FC:], vctx, qc[..., :FC, :], qc[..., FC:, :],
                *grid, vcand),
            fi_ops.k3_work(R, N, FC, FCAND, K)),
        "ffm_interaction_matrix": (
            lambda: fi_ops.ffm_interaction_matrix(randn(N, F, F, K),
                                                  randn(N, F)),
            fi_ops.k4_work(N, F, K)),
        "ffm_fused_logits_q8": (
            lambda: fi_ops.ffm_fused_logits_q8(
                ectx, vctx, depth, base, qc[..., :FC, :], qc[..., FC:, :],
                *grid, vcand),
            fi_ops.k5_work(R, N, FC, FCAND, K)),
        "ffm_fused_logits_rows": (
            lambda: fi_ops.ffm_fused_logits_rows(
                ectx, vctx, depth, base, ec[..., :FC, :], ec[..., FC:, :],
                vcand),
            fi_ops.k6_work(R, N, FC, FCAND, K)),
    }


# chip_smoke.py's bounds at the main shape before the kernels booked their
# work (its inline formulas), which k1_work ... k6_work must keep
def _inline_bounds():
    m, rowlen = N * F, F * K
    rnc = R * N * FCAND
    outs = R * N * (FC * FCAND + FCAND * FCAND)
    ctx = R * (FC * FCAND * K + FC) * 4 + rnc * 4
    n_aa = FCAND * (FCAND - 1) // 2
    io = R * (FC * F * K + FC + 1 + FC * FC) * 4 + R * N * 2 * 4 + rnc * 4

    def fused_flops(q8):
        per_cand = (FC * FCAND * (2 * K + 3 + (K + 3 if q8 else 0))
                    + n_aa * (2 * K + 3 + (4 * K + 10 if q8 else 0)) + 3)
        return R * FC * FC * (2 * K + 3) + R * N * per_cand

    return {
        "gather_dequant_rows_q8": (2 * m * rowlen,
                                   m * (rowlen + 4 + 8) + m * rowlen * 4),
        "ffm_candidate_matrices": (outs * (2 * K + 2),
                                   ctx + rnc * F * K * 4 + outs * 4),
        "ffm_candidate_matrices_q8": (outs * (2 * K + 2) + rnc * F * K * 2,
                                      ctx + rnc * (F * K + 8) + outs * 4),
        "ffm_interaction_matrix": (N * F * F * (2 * K + 2),
                                   N * (F * F * K + F + F * F) * 4),
        "ffm_fused_logits_q8": (fused_flops(True), io + rnc * (F * K + 8)),
        "ffm_fused_logits_rows": (fused_flops(False), io + rnc * F * K * 4),
    }


@pytest.mark.parametrize("name", sorted(_inline_bounds()))
def test_kernel_booking_equals_its_work(name):
    fn, work = _kernel_cases()[name]
    assert work == _inline_bounds()[name]
    with op_analysis.Counter() as c:
        fn()
    # the booking and nothing else: the plain version's ops are not counted
    assert dict(c.kernels) == {name: [1, *work]}
    assert (c.flops, c.bytes) == work


ENGINES = [("deepffm", True, True, False), ("deepffm", False, True, False),
           ("deepffm", True, False, False), ("ffm", True, True, True),
           ("ffm", False, False, True)]


@pytest.mark.parametrize("model,quantized,host,fused", ENGINES)
def test_serving_roofline_counts_the_deployed_forward(model, quantized, host,
                                                      fused):
    params = params_from_numpy(_np_params(model), "cpu")
    eng = InferenceEngine(CFG, model, params=params, device="cpu",
                          quantized=quantized, host_gather=host, fused=fused,
                          warmup_buckets=(8, 64))
    roof = serving_roofline(eng, rb=8, nb=64, scenario="cpu",
                            measured_preds_per_s=1e5,
                            bandwidth_bytes_per_s=1e10)
    dummies = eng._warmup_dummies(8, 64)
    with op_analysis.Counter() as c:
        eng._candidates_forward(eng.params, *dummies)
    assert (roof.counted_flops_per_call, roof.counted_bytes_per_call) == \
        (c.flops, c.bytes)
    kname = {(False, True): "ffm_candidate_matrices_q8",
             (False, False): "ffm_candidate_matrices",
             (True, True): "ffm_fused_logits_q8",
             (True, False): "ffm_fused_logits_rows"}[(fused, quantized)]
    assert c.kernels[kname][0] == 1
    assert roof.host_bytes_per_call == eng.host_gather_bytes(8, 64)
    assert roof.predictions_per_call == 512
    assert roof.host_bandwidth_bytes_per_s is None  # one memory on the CPU
    assert roof.bound_preds_per_s == 1e10 / roof.bytes_per_prediction
