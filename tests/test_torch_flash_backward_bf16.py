"""The bf16 bodies of flash attention's backward (K13: dQ; K12: dK, dV) and
the bound ``chip_smoke.py`` holds them to.

The wgmma bodies round P and dS to bf16 before their products (K12 forms dS
from the rounded P), sum in f32 and round each gradient once. So a gradient
may sit 2u (A + |g|) + ``BWD_REL`` max |g| from the plain backward's, u =
2^-8, A the same products on absolute values
(``ref.flash_attention_bwd_abs_ref``). On the CPU, at every (qk, v) pair of
``ops.HEAD_DIMS``, under the causal mask, unmasked with Sq != Sk, and under
a window with S ragged to the 64-row tiles, on seeded numpy inputs:

* ``flash_attention_bwd_abs_ref`` equals the same products on absolute
  values written out in numpy (float64, heads repeated rather than
  grouped), within 1e-5 of each tensor's largest value (f32 against f64);
* a torch emulation of the bodies' roundings stays within the bound against
  ``flash_attention_bwd_ref`` (``chip_smoke.bwd_bf16_share`` at most 1);
* two controls exceed it, so it is not vacuous: the emulation with Delta
  dropped (dq and dk), and with dK's D^-1/2 dropped;
* ``chip_smoke.flash_bwd_smem_bytes`` fits the 232,448 B a block may use,
  for both bodies; ``csrc/flash_attention_bwd.cu`` holds no atomic;
  ``ops.tma_ready`` hands on an aligned contiguous tensor.

With a card (``gpu`` marker; each test decides in its body and skips
without one): the kernels themselves within the bound, two calls
bit-identical, at the same shapes.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops, ref

ROOT = Path(__file__).resolve().parents[1]
KV, G = 2, 2
# (B, Sq, Sk, causal, window) of each mask
MASKS = {"causal": (2, 80, 80, True, 0), "unmasked": (2, 24, 72, False, 0),
         "window": (2, 100, 100, True, 33)}


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(d, dv, mask, device="cpu", seed=0):
    """q, k, v, do in bf16 and K11's o (bf16) and lse (f32) from the plain
    forward."""
    b, sq, sk, causal, window = MASKS[mask]
    rng = np.random.default_rng(seed)
    h = KV * G
    arrays = (rng.normal(size=(b, sq, h, d)), rng.normal(size=(b, sk, KV, d)),
              rng.normal(size=(b, sk, KV, dv)),
              rng.normal(size=(b, sq, h, dv)))
    q, k, v, do = (torch.tensor(a, dtype=torch.float32)
                   .to(device=device, dtype=torch.bfloat16) for a in arrays)
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    return q, k, v, o, lse, do, causal, window


def _numpy_abs_terms(q, k, v, o, lse, do, causal, window):
    """A_dq, A_dk, A_dv in float64 with each kv head repeated over its query
    heads (the sums over G taken after the products)."""
    q, k, v, o, do = (t.float().numpy().astype(np.float64)
                      for t in (q, k, v, o, do))
    lse = lse.numpy().astype(np.float64)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5
    rows, cols = np.arange(sq)[:, None], np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= cols <= rows
    if window:
        keep &= cols > rows - window
    kh, vh = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    s = np.einsum("bqhd,bshd->bhqs", q, kh) * scale
    p = np.where(keep, np.exp(s - lse[..., None]), 0.0)
    delta = (do * o).sum(-1).transpose(0, 2, 1)[..., None]
    ds = p * (np.einsum("bqhd,bshd->bhqs", do, vh) - delta)
    a_dq = np.einsum("bhqs,bshd->bqhd", np.abs(ds), np.abs(kh)) * scale
    a_dk = np.einsum("bhqs,bqhd->bshd", np.abs(ds), np.abs(q)) * scale
    a_dv = np.einsum("bhqs,bqhd->bshd", p, np.abs(do))
    return (a_dq, a_dk.reshape(b, sk, kv, g, d).sum(3),
            a_dv.reshape(b, sk, kv, g, -1).sum(3))


def _emulate(q, k, v, o, lse, do, causal, window, delta=True,
             dk_scale=True):
    """The wgmma bodies' arithmetic in torch: f32 products and sums; K13
    rounds dS to bf16, K12 rounds P, forms dS from the rounded P and rounds
    it; each gradient rounded to bf16 once. ``delta`` / ``dk_scale`` False
    are the controls: Delta taken as 0, dK not scaled by D^-1/2."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv

    def bf(t):
        return t.to(torch.bfloat16).float()

    scale = d ** -0.5
    q5 = q.float().reshape(b, sq, kv, g, d)
    do5 = do.float().reshape(b, sq, kv, g, -1)
    s = torch.einsum("bqkgd,bskd->bkgqs", q5, k.float()) * scale
    rows = torch.arange(sq)[:, None]
    cols = torch.arange(sk)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        keep &= cols <= rows
    if window:
        keep &= cols > rows - window
    p = torch.exp(s - lse.reshape(b, kv, g, sq)[..., None]).masked_fill(
        ~keep, 0.0)
    dl = (do5 * o.float().reshape(b, sq, kv, g, -1)).sum(-1)
    dl = dl.permute(0, 2, 3, 1)[..., None] if delta else 0.0
    dp = torch.einsum("bqkgd,bskd->bkgqs", do5, v.float())
    ds13 = bf(p * (dp - dl))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds13, k.float()) * scale
    pb = bf(p)
    ds12 = bf(pb * (dp - dl))
    dk = (torch.einsum("bkgqs,bqkgd->bskd", ds12, q5)
          * (scale if dk_scale else 1.0))
    dv = torch.einsum("bkgqs,bqkgd->bskd", pb, do5)
    return (dq.reshape(b, sq, h, d).to(torch.bfloat16),
            dk.to(torch.bfloat16), dv.to(torch.bfloat16))


def _shares(smoke, got, want, terms):
    return [smoke.bwd_bf16_share(g, w, a)
            for g, w, a in zip(got, want, terms)]


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("d,dv", ops.HEAD_DIMS)
def test_abs_ref_matches_numpy(d, dv, mask):
    args = _inputs(d, dv, mask)
    q, k, v, o, lse, do, causal, window = args
    got = ref.flash_attention_bwd_abs_ref(q, k, v, o, lse, do, causal=causal,
                                          window=window)
    want = _numpy_abs_terms(*args)
    for name, g, w in zip(("a_dq", "a_dk", "a_dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("d,dv", ops.HEAD_DIMS)
def test_emulated_roundings_within_bound(smoke, d, dv, mask):
    q, k, v, o, lse, do, causal, window = _inputs(d, dv, mask)
    kw = {"causal": causal, "window": window}
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    terms = ref.flash_attention_bwd_abs_ref(q, k, v, o, lse, do, **kw)
    got = _emulate(q, k, v, o, lse, do, causal, window)
    shares = _shares(smoke, got, want, terms)
    assert max(shares) <= 1, shares
    # the roundings move the gradients: the bound is not met trivially
    assert any(not torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("control", ["no_delta", "no_dk_scale"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("d,dv", ops.HEAD_DIMS)
def test_bound_rejects_controls(smoke, d, dv, mask, control):
    q, k, v, o, lse, do, causal, window = _inputs(d, dv, mask)
    kw = {"causal": causal, "window": window}
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    terms = ref.flash_attention_bwd_abs_ref(q, k, v, o, lse, do, **kw)
    got = _emulate(q, k, v, o, lse, do, causal, window,
                   delta=control != "no_delta",
                   dk_scale=control != "no_dk_scale")
    dq_share, dk_share, _ = _shares(smoke, got, want, terms)
    if control == "no_delta":
        assert dq_share > 1 and dk_share > 1, (dq_share, dk_share)
    else:
        assert dk_share > 1, dk_share


@pytest.mark.parametrize("d,dv", ops.HEAD_DIMS)
def test_bwd_smem_fits(smoke, d, dv):
    for bf16 in (True, False):
        for nbytes in smoke.flash_bwd_smem_bytes(d, dv, bf16):
            assert 0 < nbytes <= 232448, (d, dv, bf16, nbytes)


def test_backward_source_has_no_atomics():
    src = (ROOT / "src/repro_torch/csrc/flash_attention_bwd.cu").read_text()
    assert "atomicAdd" not in src and "atom." not in src and "red." not in src


def test_tma_ready_hands_on_aligned_contiguous():
    x = torch.arange(65, dtype=torch.bfloat16)
    assert ops.tma_ready(x[:64]).data_ptr() == x.data_ptr()  # kept as is
    off = x[1:]  # 2 bytes past an aligned start
    got = ops.tma_ready(off)
    assert got.data_ptr() % ops.TMA_ALIGN == 0 and torch.equal(got, off)
    strided = x[:64].reshape(8, 8).t()
    got = ops.tma_ready(strided)
    assert got.is_contiguous() and torch.equal(got, strided)


@pytest.mark.gpu
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("d,dv", ops.HEAD_DIMS)
def test_wgmma_bodies_within_bound_on_card(smoke, d, dv, mask):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wgmma bodies run only on sm_90a")
    q, k, v, o, lse, do, causal, window = _inputs(d, dv, mask, "cuda")
    kw = {"causal": causal, "window": window}
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    _build.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention_bwd_dq"] == 2
    assert _build.launches["flash_attention_bwd_dkdv"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    terms = ref.flash_attention_bwd_abs_ref(q, k, v, o, lse, do, **kw)
    shares = _shares(smoke, got, want, terms)
    assert max(shares) <= 1, shares
