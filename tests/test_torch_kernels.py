"""Port kernels' plain versions against the JAX Pallas kernels (interpret mode).

On the CPU every wrapper of ``repro_torch.kernels`` runs its kernel's plain
PyTorch version; these tests hold those against the Pallas functions the
CUDA kernels replace, on the same seeded numpy inputs, with the JAX
package's own tolerances (``test_kernels.py``, ``test_serving_engine.py``,
``test_quantized_serving.py``). Shapes include candidate counts that are not
multiples of the Pallas tile (which pads; the port's kernels mask).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import FFMConfig as JFFMConfig
from repro.core import quantization as JQ
from repro.kernels.ffm_interaction import ops as j_ops
from repro.kernels.ffm_interaction.ffm_interaction import (
    ffm_candidate_matrices, ffm_candidate_matrices_q8, ffm_interaction_matrix)
from repro.kernels.row_gather.row_gather import gather_dequant_rows_q8
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ffm_interaction import ops as t_ops
from repro_torch.kernels.row_gather import ops as t_rg

CFG = FFMConfig(n_fields=8, context_fields=5, hash_space=2**10, k=4,
                mlp_hidden=(16, 8))
JCFG = JFFMConfig(**CFG.__dict__)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# test_kernels.py's sweep, then the main path's shape (B = 64 candidates of
# the default config) and an odd F with K != 8 (the kernel's runtime-K loop)
@pytest.mark.parametrize("B,F,K", [(4, 4, 2), (32, 24, 8), (100, 24, 8),
                                   (7, 10, 16), (1, 6, 4), (64, 24, 8),
                                   (5, 13, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffm_interaction_matrix_matches_pallas(B, F, K, dtype):
    rng = np.random.default_rng(B * F + K)
    e = rng.normal(size=(B, F, F, K)).astype(np.float32)
    v = rng.normal(size=(B, F)).astype(np.float32)
    want = ffm_interaction_matrix(jnp.asarray(e).astype(dtype),
                                  jnp.asarray(v).astype(dtype), block_b=16)
    got = t_ops.ffm_interaction_matrix(_t(e).to(getattr(torch, dtype)),
                                       _t(v).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 10)


CAND_SHAPES = [(1, 5, 3, 2, 4), (3, 9, 8, 4, 8), (2, 64, 4, 7, 2),
               (2, 6, 5, 1, 4), (8, 37, 16, 8, 8), (3, 53, 16, 8, 8)]


@pytest.mark.parametrize("R,N,Fc,Fcand,K", CAND_SHAPES)
@pytest.mark.parametrize("quantized", [False, True])
def test_candidate_matrices_match_pallas(R, N, Fc, Fcand, K, quantized):
    rng = np.random.default_rng(R * N + K)
    ectx = rng.normal(size=(R, Fc, Fcand, K)).astype(np.float32)
    vctx = rng.normal(size=(R, Fc)).astype(np.float32)
    vcand = rng.normal(size=(R, N, Fcand)).astype(np.float32)
    if quantized:
        cx = rng.integers(-127, 128, (R, N, Fcand, Fc, K)).astype(np.int8)
        cc = rng.integers(-127, 128, (R, N, Fcand, Fcand, K)).astype(np.int8)
        grids = (rng.uniform(1e-4, 1e-2, (R, N, Fcand)).astype(np.float32),
                 rng.normal(0, 0.05, (R, N, Fcand)).astype(np.float32))
        want = ffm_candidate_matrices_q8(ectx, vctx, cx, cc, *grids, vcand,
                                         block_n=16)
        got = t_ops.ffm_candidate_matrices_q8(
            _t(ectx), _t(vctx), _t(cx), _t(cc), *map(_t, grids), _t(vcand))
        tol = dict(rtol=1e-5, atol=1e-6)
    else:
        cx = rng.normal(size=(R, N, Fcand, Fc, K)).astype(np.float32)
        cc = rng.normal(size=(R, N, Fcand, Fcand, K)).astype(np.float32)
        want = ffm_candidate_matrices(ectx, vctx, cx, cc, vcand, block_n=16)
        got = t_ops.ffm_candidate_matrices(_t(ectx), _t(vctx), _t(cx),
                                           _t(cc), _t(vcand))
        tol = dict(rtol=1e-5, atol=1e-5)
    assert got[0].shape == (R, N, Fc, Fcand)
    assert got[1].shape == (R, N, Fcand, Fcand)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("V,row,idx_shape", [
    (64, (6, 4), (17,)), (256, (12, 8), (48,)), (33, (3, 2), (5,)),
    (128, (4, 2), (3, 7)), (1024, (24, 8), (64, 24)), (512, (5, 8), (9, 4))])
def test_gather_dequant_rows_matches_pallas(V, row, idx_shape):
    rng = np.random.default_rng(V + len(idx_shape))
    codes = rng.integers(-127, 128, (V,) + row).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, V).astype(np.float32)
    zero = rng.normal(0, 0.05, V).astype(np.float32)
    idx = rng.integers(0, V, idx_shape).astype(np.int32)
    want = gather_dequant_rows_q8(jnp.asarray(codes), jnp.asarray(scale),
                                  jnp.asarray(zero), jnp.asarray(idx))
    got = t_rg.gather_dequant_rows_q8(_t(codes), _t(scale), _t(zero), _t(idx))
    assert tuple(got.shape) == idx_shape + row
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


def _tables(quantized: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 0.3, (CFG.hash_space, CFG.n_fields, CFG.k)
                     ).astype(np.float32)
    return JQ.quantize_rows(emb) if quantized else emb


@pytest.mark.parametrize("op", ["interactions", "candidate_interactions"])
@pytest.mark.parametrize("quantized", [False, True])
def test_ops_match_jax_ops(op, quantized):
    """The ops-level entry points (pair-column gathers included) against the
    JAX ops on the same tables; ``interactions`` on an int8 table goes
    through the row gather first."""
    rng = np.random.default_rng(7)
    emb = _tables(quantized)
    temb = params_from_numpy({"t": emb}, "cpu")["t"]
    jemb = ({k: jnp.asarray(v) for k, v in emb.items()} if quantized
            else jnp.asarray(emb))
    fc, fcand = CFG.context_fields, CFG.n_fields - CFG.context_fields
    if op == "interactions":
        idx = rng.integers(0, CFG.hash_space, (9, CFG.n_fields)).astype(np.int32)
        val = rng.uniform(0.5, 2.0, (9, CFG.n_fields)).astype(np.float32)
        want = [j_ops.interactions(JCFG, jemb, jnp.asarray(idx),
                                   jnp.asarray(val))]
        got = [t_ops.interactions(CFG, temb, _t(idx), _t(val))]
    else:
        R, N = 3, 11
        ectx = rng.normal(0, 0.3, (R, fc, CFG.n_fields, CFG.k)).astype(np.float32)
        vctx = rng.uniform(0.5, 2.0, (R, fc)).astype(np.float32)
        ki = rng.integers(0, CFG.hash_space, (R, N, fcand))
        kv = rng.uniform(0.5, 2.0, (R, N, fcand)).astype(np.float32)
        if quantized:
            blk = (emb["codes"][ki], emb["scale"][ki], emb["zero"][ki])
            want = j_ops.candidate_interactions_q8(JCFG, ectx, vctx, *blk, kv)
            got = t_ops.candidate_interactions_q8(
                CFG, _t(ectx), _t(vctx), *map(_t, blk), _t(kv))
        else:
            want = j_ops.candidate_interactions(JCFG, ectx, vctx, emb[ki], kv)
            got = t_ops.candidate_interactions(CFG, _t(ectx), _t(vctx),
                                               _t(emb[ki]), _t(kv))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
