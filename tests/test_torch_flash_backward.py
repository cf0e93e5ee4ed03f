"""The flash-attention backward's plain version and the autograd route on the
CPU.

* ``ref.flash_attention_bwd_ref`` (the arithmetic of K13 / K12, which
  recompute P from K11's log-sum-exp) against ``jax.vjp`` of the JAX
  package's jnp flash (``repro.models.attention.flash_attention``, the
  attention the JAX models train through), per (dq, dk, dv), at every (qk,
  v) head-dim pair of ``ops.HEAD_DIMS``, under the causal mask, unmasked
  with Sq != Sk, and under a window, at G = 1, 2 and 4 query heads per kv
  head, in f32: within 2e-5 of each tensor's largest |gradient| (f32 sums
  in other orders). The jnp flash takes v at the qk width, so for (48, 32)
  and (192, 128) v is zero-padded to it on the JAX side and the cotangent
  too; dv is sliced back.
* The plain log-sum-exp (``return_lse``) against numpy's, in float64 on
  the same f32 scores, within 1e-5; ``flash_attention_fwd`` returns it.
* ``ops.flash_attention`` takes :class:`ops.FlashAttention` only when
  autograd needs a gradient: its gradients equal autograd through the plain
  forward within 2e-5; without grad mode the plain forward runs, no kernel
  launches on CPU tensors; ``flash_attention_bwd`` rejects mismatched
  shapes and dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attention
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops, ref

TOL = 2e-5  # share of each gradient's largest |value|
KV = 2
# (Sq, Sk, causal, window) of each mask
MASKS = {"causal": (24, 24, True, 0), "unmasked": (24, 40, False, 0),
         "window": (40, 40, True, 9)}


def _inputs(d, dv, g, sq, sk, seed=0):
    rng = np.random.default_rng(seed)
    h = KV * g
    q = rng.normal(size=(2, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(2, sk, KV, d)).astype(np.float32)
    v = rng.normal(size=(2, sk, KV, dv)).astype(np.float32)
    do = rng.normal(size=(2, sq, h, dv)).astype(np.float32)
    return q, k, v, do


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("d,dv", ops.HEAD_DIMS)
def test_bwd_ref_matches_jax_grad(d, dv, mask, g):
    sq, sk, causal, window = MASKS[mask]
    q, k, v, do = _inputs(d, dv, g, sq, sk)
    pad = ((0, 0), (0, 0), (0, 0), (0, d - dv))

    def jflash(q_, k_, v_):
        return j_attention.flash_attention(q_, k_, v_, causal=causal,
                                           window=window)

    _, vjp = jax.vjp(jflash, jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(np.pad(v, pad)))
    jdq, jdk, jdv = vjp(jnp.asarray(np.pad(do, pad)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                     return_lse=True)
    dq, dk, dv_ = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                              causal=causal, window=window)
    _close(dq, jdq, "dq")
    _close(dk, jdk, "dk")
    _close(dv_, np.asarray(jdv)[..., :dv], "dv")


@pytest.mark.parametrize("mask", list(MASKS))
def test_lse_matches_numpy(mask):
    sq, sk, causal, window = MASKS[mask]
    q, k, v, _ = _inputs(64, 64, 2, sq, sk, seed=1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                     window=window, return_lse=True)
    s, _ = ref._scores(tq, tk)  # (B, Kv, G, Sq, Sk) f32, scaled
    s = s.double().numpy()
    rows, cols = np.arange(sq)[:, None], np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= cols <= rows
    if window:
        keep &= cols > rows - window
    s = np.where(keep, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, sq)
    np.testing.assert_allclose(lse.numpy(), want.reshape(2, 4, sq),
                               rtol=1e-5, atol=1e-5)
    out, lse2 = ops.flash_attention_fwd(tq, tk, tv, causal=causal,
                                        window=window)
    assert torch.equal(lse2, lse)
    assert torch.equal(out, ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                                    window=window))


@pytest.mark.parametrize("d,dv", [(64, 64), (48, 32)])
def test_function_grads_match_autograd_through_ref(d, dv):
    q, k, v, do = _inputs(d, dv, 2, 24, 24, seed=2)
    before = dict(_build.launches)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, window=7)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    plain = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*plain, window=7),
                               plain, torch.from_numpy(do))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b.numpy(), name)
    with torch.no_grad():
        plain_out = ops.flash_attention(*leaves, window=7)
    assert plain_out.grad_fn is None
    assert torch.equal(plain_out, out.detach())
    assert _build.launches == before  # CPU tensors: no kernel


def test_bwd_rejects_bad_arguments():
    q, k, v, do = map(torch.from_numpy, _inputs(32, 32, 2, 8, 8))
    o, lse = ops.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, o, lse[:, :, :4], do)
    with pytest.raises(ValueError, match="must be"):
        ops.flash_attention_bwd(q, k, v, o.double(), lse, do)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention_bwd(q[..., :24], k[..., :24], v, o, lse, do)
