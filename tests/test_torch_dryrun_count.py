"""The op counter (``repro_torch/launch/op_analysis.py``) and the kernels'
bookings, on the CPU.

* The counter's rules, the counterparts of the JAX analyzer's tests
  (``tests/test_distribution.py``): 2mnk FLOPs for a matmul and none for
  elementwise ops; a Python loop of 5 layers counted 5 times (JAX's
  scan-trip test); 32 rows read from a 100,000 x 64 table cost under 1 MB
  (JAX's gather test); a one-column write into a 4 MB cache costs under
  4 MB (JAX's in-place update test); views and ``empty`` cost nothing; a
  storage counts toward the peak until it is freed.
* Collectives on a fake 4-rank world: each kind at its result's bytes, a
  group of one rank at nothing.
* K11, K13, K12 and K10 book the work of their bound formulas on meta and
  CPU tensors alike, the ops of their bodies uncounted; a launch under a
  counter outside a booking raises; meta calls move no launch count; with
  no counter open a booking computes no work. The closed form of
  ``attention_pairs`` equals a count over the mask's rows.
* The dry run's steps (``dryrun_lib.build_step``: ZeRO-1 train, prefill,
  decode) of llama3.2-1b's smoke config on a fake 2 x 2 world, on the meta
  device, count exactly what rank 0 of a gloo 2 x 2 world counts running
  them on real CPU tensors (FLOPs, bytes, collective bytes and calls by
  kind): the dry run describes the code that runs.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.common.config import InputShape
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.sparse_mlp import ops as sk_ops
from repro_torch.launch import dryrun_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.op_analysis import Counter, kernel, tensor_bytes
from repro_torch.models import registry
from tests import _torch_dryrun_ranks as D

DEVICES = ("meta", "cpu")
COUNT_SHAPES = [("train_s", 16, 4, "train"), ("prefill_s", 16, 4, "prefill"),
                ("decode_s", 16, 4, "decode")]


@pytest.mark.parametrize("device", DEVICES)
def test_matmul_counts_2mnk_and_elementwise_nothing(device):
    a = torch.zeros(64, 32, device=device)
    b = torch.zeros(32, 48, device=device)
    with Counter() as c:
        y = a @ b
    assert c.flops == 2 * 64 * 32 * 48
    assert c.bytes == (64 * 32 + 32 * 48 + 64 * 48) * 4
    with Counter() as c:
        torch.tanh(y + 1.0)
    assert c.flops == 0 and c.bytes == 2 * 2 * 64 * 48 * 4


@pytest.mark.parametrize("device", DEVICES)
def test_python_loop_counted_per_trip(device):
    x = torch.zeros(64, 32, device=device)
    ws = torch.zeros(5, 32, 32, device=device)
    with Counter() as c:
        for w in ws.unbind(0):
            x = torch.tanh(x @ w)
    assert c.flops == 5 * 2 * 64 * 32 * 32


@pytest.mark.parametrize("device", DEVICES)
def test_indexed_reads_cost_the_rows(device):
    table = torch.zeros(100_000, 64, device=device)
    idx = torch.zeros(32, dtype=torch.long, device=device)
    for read in (lambda: table[idx], lambda: table.index_select(0, idx),
                 lambda: torch.nn.functional.embedding(idx, table),
                 lambda: table.gather(0, idx[:, None].expand(32, 64))):
        with Counter() as c:
            read()
        assert c.bytes < 1_000_000


@pytest.mark.parametrize("device", DEVICES)
def test_slice_writes_cost_the_slice(device):
    cache = torch.zeros(1024, 1024, device=device)
    upd = torch.zeros(1024, 1, device=device)
    with Counter() as c:
        cache[:, 5:6] = upd
    assert 0 < c.bytes < 1024 * 1024 * 4
    rows = torch.zeros(4, dtype=torch.long, device=device)
    with Counter() as c:
        cache.index_put_((rows,), torch.zeros(4, 1024, device=device))
        cache.index_copy_(0, rows, torch.zeros(4, 1024, device=device))
    assert 0 < c.bytes < 1024 * 1024 * 4


@pytest.mark.parametrize("device", DEVICES)
def test_views_and_empty_cost_nothing_and_peak_follows_storages(device):
    x = torch.zeros(8, 16, device=device)
    with Counter() as c:
        x.view(16, 8).t()[2:].unsqueeze(0).expand(3, 6, 16)
        torch.empty(1000, device=device)
    assert c.bytes == 0 and c.flops == 0
    with Counter() as c:
        a = torch.empty(1000, device=device)
        del a
        b = torch.empty(500, device=device)
    assert c.peak_bytes == 4000 and c.live_bytes == 2000
    assert tensor_bytes(b[None].expand(7, 500)) == 2000


def test_collectives_by_kind_and_a_group_of_one_counts_nothing():
    with mesh_lib.fake_world(4):
        alone, four = dist.new_group([0]), dist.new_group([0, 1, 2, 3])
        x = torch.empty(4, 8, device="meta")
        with Counter() as c:
            dist.all_reduce(x, group=alone)
            dist.all_gather_into_tensor(torch.empty(4, 8, device="meta"), x,
                                        group=alone)
        assert c.collective_bytes == 0
        with Counter() as c:
            dist.all_reduce(x, group=four)
            dist.all_gather_into_tensor(torch.empty(16, 8, device="meta"), x,
                                        group=four)
            dist.reduce_scatter_tensor(torch.empty(1, 8, device="meta"), x,
                                       group=four)
            dist.all_to_all_single(torch.empty_like(x), x, group=four)
        s = c.collective_stats()
        assert (s["all-reduce_bytes"], s["all-gather_bytes"],
                s["reduce-scatter_bytes"], s["all-to-all_bytes"]) == \
            (128, 512, 32, 128)
        assert s["all-reduce_count"] == 1 and s["total_bytes"] == 800
        assert c.flops == 0 and c.bytes == 0


def test_attention_pairs_and_work_formulas():
    assert fa_ops.attention_pairs(4, 4, True, 0) == 10
    assert fa_ops.attention_pairs(4, 4, False, 0) == 16
    assert fa_ops.attention_pairs(5, 5, True, 2) == 9
    assert fa_ops.attention_pairs(2, 6, True, 0) == 3
    assert fa_ops.attention_pairs(32768, 32768, True, 0) == \
        32768 * 32769 // 2
    q, k = (2, 4, 8, 16), (2, 4, 2, 16)
    flops, nbytes = fa_ops.k11_work(q, k, k, 4, True, 0, with_lse=True)
    assert flops == 2 * 32 * 2 * 8 * 10
    assert nbytes == 4 * (2 * 4 * 8 * 32 + 2 * 4 * 2 * 32) + 4 * 2 * 8 * 4
    assert fa_ops.k13_work(q, k, k, 2, True)[0] == 2 * 48 * 2 * 8 * 10
    assert fa_ops.k12_work(q, k, k, 2, True)[0] == 2 * 64 * 2 * 8 * 10
    assert sk_ops.k10_work((512, 277), (512, 64)) == (
        2 * 512 * 277 * 64, 4 * (512 * 277 + 512 * 64 + 277 * 64))


def _pairs_by_rows(sq, sk, causal, window):
    """The mask's kept (row, column) pairs counted row by row."""
    r = np.arange(sq, dtype=np.int64)
    hi = np.minimum(r, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, r - window + 1) if window > 0 else np.zeros(sq)
    return int(np.maximum(0, hi - lo + 1).sum())


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 3),
                                           (False, 3), (True, 17)])
def test_attention_pairs_closed_form_matches_the_mask(causal, window):
    for sq in range(0, 21):
        for sk in range(0, 21):
            assert fa_ops.attention_pairs(sq, sk, causal, window) == \
                _pairs_by_rows(sq, sk, causal, window), (sq, sk)
    for sq, sk in ((4096, 4096), (1, 32768), (32768, 1024), (1000, 300)):
        assert fa_ops.attention_pairs(sq, sk, causal, window) == \
            _pairs_by_rows(sq, sk, causal, window), (sq, sk)


def test_booking_computes_no_work_without_a_counter():
    calls = []

    def work():
        calls.append(1)
        return 3, 5

    with _build.booking("flash_attention", work):
        pass
    assert calls == [] and _build._open_counters == 0
    with Counter() as c:
        assert _build._open_counters == 1
        with _build.booking("flash_attention", work):
            pass
    assert calls == [1] and c.kernels["flash_attention"] == [1, 3, 5]
    with pytest.raises(ValueError):
        with Counter():
            raise ValueError("left through an exception")
    assert _build._open_counters == 0


@pytest.mark.parametrize("device", DEVICES)
def test_kernel_bookings_match_their_formulas(device):
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g).to(device)

    q, k, v = rand(2, 12, 4, 16), rand(2, 12, 2, 16), rand(2, 12, 2, 16)
    before = dict(_build.launches)
    with Counter() as c:
        out = fa_ops.flash_attention(q, k, v, causal=True, window=5)
    assert tuple(out.shape) == (2, 12, 4, 16) and out.device.type == device
    assert c.kernels["flash_attention"] == [1, *fa_ops.k11_work(
        q.shape, k.shape, v.shape, 4, True, 5)]
    assert (c.flops, c.bytes, c.n_ops) == (*fa_ops.k11_work(
        q.shape, k.shape, v.shape, 4, True, 5), 0)
    for t in (q, k, v):
        t.requires_grad_()
    with Counter() as c:
        fa_ops.flash_attention(q, k, v).sum().backward()
    for name, work in (("flash_attention", fa_ops.k11_work(
            q.shape, k.shape, v.shape, 4, True, 0, with_lse=True)),
                       ("flash_attention_bwd_dq", fa_ops.k13_work(
                           q.shape, k.shape, v.shape, 4, True)),
                       ("flash_attention_bwd_dkdv", fa_ops.k12_work(
                           q.shape, k.shape, v.shape, 4, True))):
        assert c.kernels[name] == [1, *work], name
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    x, gm = rand(40, 24), rand(40, 8)
    with Counter() as c:
        dw = sk_ops.sparse_weight_grad(x, gm)
    assert tuple(dw.shape) == (24, 8)
    assert c.kernels["sparse_weight_grad"] == [1, *sk_ops.k10_work(
        x.shape, gm.shape)] and c.n_ops == 0
    assert dict(_build.launches) == before


def test_launch_under_a_counter_needs_a_booking():
    with Counter():
        with pytest.raises(RuntimeError, match="booking"):
            _build.launch("flash_attention")
        with kernel("flash_attention", 0, 0):
            pass  # booked: the check passes (no card here to launch on)


@pytest.fixture(scope="module")
def real_counts(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dryrun_count"))
    mesh_lib.spawn(D.count_rank, 4, out_dir, "llama3.2-1b", COUNT_SHAPES)
    with open(os.path.join(out_dir, "counts.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("fields", COUNT_SHAPES, ids=lambda f: f[0])
def test_meta_counts_equal_real_cpu_counts_at_2x2(real_counts, fields):
    cfg = registry.get_config("llama3.2-1b", smoke=True)
    with mesh_lib.fake_world(4):
        rt = mesh_lib.make_runtime(mesh_lib.make_smoke_mesh(2, 2))
        fn, args, mine = dryrun_lib.build_step(cfg, InputShape(*fields), rt)
        counter, memory, _ = dryrun_lib.count_step(fn, args, mine)
    real = real_counts[fields[0]]
    assert counter.totals() == real["totals"]
    assert {k: list(v) for k, v in counter.kernels.items()} == \
        real["kernels"]
    assert counter.flops > 0 and counter.collective_bytes > 0
    assert counter.kernels["flash_attention"][0] == (
        cfg.n_layers if fields[3] != "decode" else 0)
    assert memory["peak_bytes"] >= memory["argument_bytes"] > 0
