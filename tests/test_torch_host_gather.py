"""The port's host pre-gather primitives against the JAX package's on the CPU.

* the packed row gathers (``gather_codes_np`` with and without ``out=``,
  ``gather_codes_chunked``, ``gather_dequant_np``) byte for byte against
  ``repro/kernels/row_gather/ops.py``'s over ``test_kernels.py``'s row
  shapes (the u64 / u32 / u16 / int8 views);
* ``ffm.gather_lr_np`` / ``gather_rows_np`` against JAX's on f32 and
  blocked / row int8 tables;
* the gather-cliff calibration: the ``REPRO_CLIFF_CALIBRATE=0`` switch, the
  cached and bounded probe with its fallback, one probe under a race
  (twins of ``test_sharded_serving.py`` / ``test_fused_scoring.py``'s);
* ``use_host_gather`` is false on the card (no allocation, no probe).
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import ffm as jffm
from repro.core import quantization as JQ
from repro.kernels.row_gather import ops as j_rg
from repro_torch.core import ffm
from repro_torch.kernels.row_gather import ops as rg_ops

ROW_SHAPES = [(24, 8), (3,), (5, 7), ()]


def _same_bytes(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("row_shape", ROW_SHAPES)
def test_packed_gather_matches_jax_byte_for_byte(row_shape):
    rng = np.random.default_rng(sum(row_shape) + 1)
    table = rng.integers(-127, 128, (100,) + row_shape).astype(np.int8)
    idx = rng.integers(0, 100, (4, 9)).astype(np.int64)
    want = j_rg.gather_codes_np(table, idx)
    _same_bytes(rg_ops.gather_codes_np(table, idx), want)
    _same_bytes(want, table[idx])
    # into a caller's buffer, and a non-contiguous one (copied back)
    out = np.empty(idx.shape + row_shape, np.int8)
    assert rg_ops.gather_codes_np(table, idx, out=out) is out
    _same_bytes(out, want)
    wide = np.zeros((4, 18) + row_shape, np.int8)
    rg_ops.gather_codes_np(table, idx, out=wide[:, ::2])
    _same_bytes(np.ascontiguousarray(wide[:, ::2]), want)
    with pytest.raises(ValueError, match="out must be"):
        rg_ops.gather_codes_np(table, idx, out=np.empty((4, 9), np.int16))
    # chunked, with a chunk that does not divide the rows
    chunked = np.empty_like(want)
    rg_ops.gather_codes_chunked(table, idx, chunked, row_chunk=5)
    _same_bytes(chunked, j_rg.gather_codes_chunked(
        table, idx, np.empty_like(want), row_chunk=5))
    # f32 tables pack too (wider words, same values)
    tf = rng.normal(size=(64,) + row_shape).astype(np.float32)
    i2 = rng.integers(0, 64, 13)
    _same_bytes(rg_ops.gather_codes_np(tf, i2), j_rg.gather_codes_np(tf, i2))


@pytest.mark.parametrize("row_shape", [(6, 4), (3,), (5, 7)])
def test_gather_dequant_np_matches_jax(row_shape):
    rng = np.random.default_rng(9)
    qt = JQ.quantize_rows(rng.normal(0, 0.1, (50,) + row_shape)
                          .astype(np.float32))
    idx = rng.integers(0, 50, (2, 11))
    _same_bytes(rg_ops.gather_dequant_np(qt, idx),
                j_rg.gather_dequant_np(qt, idx))


def test_gather_lr_np_and_gather_rows_np_match_jax():
    rng = np.random.default_rng(23)
    w = rng.normal(0, 0.1, 500).astype(np.float32)
    idx = rng.integers(0, 500, (7, 3))
    for lr in (w, JQ.quantize_blocks(w, block=64)):
        _same_bytes(ffm.gather_lr_np(lr, idx), jffm.gather_lr_np(lr, idx))
    emb = rng.normal(0, 0.1, (500, 6, 4)).astype(np.float32)
    for table in (emb, JQ.quantize_rows(emb)):
        _same_bytes(ffm.gather_rows_np(table, idx),
                    jffm.gather_rows_np(table, idx))
    # the port's host mirror holds numpy views of torch tensors: same bytes
    q = JQ.quantize_blocks(w, block=64)
    mirror = {k: (torch.from_numpy(v).numpy() if isinstance(v, np.ndarray)
                  else v) for k, v in q.items()}
    _same_bytes(ffm.gather_lr_np(mirror, idx), jffm.gather_lr_np(q, idx))


def test_cliff_env_kill_switch(monkeypatch):
    monkeypatch.setenv("REPRO_CLIFF_CALIBRATE", "0")
    assert rg_ops.cliff_rows() == rg_ops.CLIFF_ROWS == j_rg.CLIFF_ROWS
    assert rg_ops._PROBE_SIZES == j_rg._PROBE_SIZES
    assert rg_ops._PROBE_MAX == j_rg._PROBE_MAX


def test_cliff_calibration_cached_and_bounded(monkeypatch):
    monkeypatch.delenv("REPRO_CLIFF_CALIBRATE", raising=False)
    monkeypatch.setattr(rg_ops, "_calibrated", None)
    got = rg_ops.cliff_rows()
    assert min(rg_ops._PROBE_SIZES) <= got <= rg_ops._PROBE_MAX
    assert rg_ops._calibrated == got  # cached per process
    monkeypatch.setattr(rg_ops, "calibrate_cliff_rows",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError()))
    monkeypatch.setattr(rg_ops, "_calibrated", None)
    assert rg_ops.cliff_rows() == rg_ops.CLIFF_ROWS  # probe failure fallback


def test_cliff_calibration_probe_runs_once_under_race(monkeypatch):
    calls = []

    def fake_probe():
        calls.append(1)
        time.sleep(0.02)  # widen the race window
        return 12345

    monkeypatch.setenv("REPRO_CLIFF_CALIBRATE", "1")
    monkeypatch.setattr(rg_ops, "_calibrated", None)
    monkeypatch.setattr(rg_ops, "calibrate_cliff_rows", fake_probe)
    results = []
    barrier = threading.Barrier(8)

    def hit():
        barrier.wait()
        results.append(rg_ops.cliff_rows())

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1
    assert results == [12345] * 8


def test_use_host_gather_only_on_the_cpu(monkeypatch):
    def no_probe(*a, **k):
        raise AssertionError("the cliff probe ran")

    monkeypatch.setattr(rg_ops, "calibrate_cliff_rows", no_probe)
    monkeypatch.setattr(rg_ops, "_calibrated", None)
    # the card: false at any size, with no probe and no allocation
    for n in (1 << 10, 1 << 18, 1 << 24):
        assert not rg_ops.use_host_gather(n, torch.device("cuda"))
        assert not rg_ops.use_host_gather(n, "cuda:0")
    # a table under every threshold the probe can return runs no probe
    assert not rg_ops.use_host_gather(1 << 13, torch.device("cpu"))
    # the CPU past the cliff: the JAX package's rule
    monkeypatch.setenv("REPRO_CLIFF_CALIBRATE", "0")
    assert rg_ops.use_host_gather(rg_ops.CLIFF_ROWS, "cpu")
    assert not rg_ops.use_host_gather(rg_ops.CLIFF_ROWS - 1, "cpu")
