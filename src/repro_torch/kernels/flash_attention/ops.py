"""Flash attention through the kernels (port of
``repro/kernels/flash_attention/ops.py``, and its backward).

:func:`flash_attention` computes ``softmax(q kᵀ D^-½ + mask) v`` with GQA.
A CPU tensor gets the plain version (``ref.py``); a CUDA tensor gets K11 in
``csrc/flash_attention.cu`` or an exception. When autograd needs its
gradient (grad mode on and q, k or v requiring one), the call goes through
:class:`FlashAttention`: K11 also writes each row's log-sum-exp, and the
backward runs K13 (dQ) then K12 (dK, dV) in ``csrc/flash_attention_bwd.cu``,
the port's own kernels (the JAX package differentiates its jnp flash by
autodiff); on CPU tensors both directions take the plain versions. Any
other call, serving's included, launches K11 without the log-sum-exp.
K13 and K12 have two bodies each, picked by dtype as K11's are
(:data:`BWD_BODIES`).

Unlike the Pallas wrapper nothing is padded or transposed and no block size
is chosen here: the kernel reads q, k and v in their (B, S, heads, D)
layouts, masks the ragged tail tiles and fixes its own tiling. K11 has two
bodies, picked by dtype (:data:`BODIES`): bf16 runs on TMA and ``wgmma``
(sm_90a), f32 on CUDA-core FMAs. v may be narrower than q and k (MLA: qk
dim 192, v dim 128), and is taken at its own width, never padded.

Every call books its kernels' work (:func:`k11_work`, :func:`k13_work`,
:func:`k12_work`: the bound formulas of PERF.md §6) with an op counter
(``launch/op_analysis.py``) through ``_build.booking`` on every device;
the work is computed only while a counter is open. A meta tensor gets its
outputs allocated and nothing else (the dry run), before the CPU / CUDA
branches, and moves no launch count.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                      flash_attention_ref)

# (qk head dim D, v head dim Dv) pairs each instance takes: D = Dv for the
# GQA families, deepseek-v2's MLA at 192 / 128 (config) and 48 / 32 (smoke)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (112, 112), (128, 128), (48, 32),
             (192, 128))
# the body of csrc/flash_attention.cu that serves each dtype, and the (D, Dv)
# pairs it is instantiated for (the C entry's switch)
BODIES = {torch.bfloat16: ("wgmma", HEAD_DIMS),  # TMA + wgmma
          torch.float32: ("cuda-core", HEAD_DIMS)}  # f32 FMAs
# the bodies of csrc/flash_attention_bwd.cu (K13 and K12) that serve each
# dtype, and their (D, Dv) pairs (the C entries' switches)
BWD_BODIES = {torch.bfloat16: ("wgmma", HEAD_DIMS),  # TMA + wgmma
              torch.float32: ("cuda-core", HEAD_DIMS)}  # f32 FMAs
TMA_ALIGN = 16  # bytes: a TMA tensor map's base address


def kernel_body(dtype: torch.dtype, d: int, dv: int) -> str:
    """The K11 body that takes (dtype, qk head dim d, v head dim dv); raise
    if none does."""
    if dtype not in BODIES:
        raise ValueError(f"flash_attention takes {tuple(BODIES)}, got {dtype}")
    body, pairs = BODIES[dtype]
    if (d, dv) not in pairs:
        raise ValueError(f"head dims (qk {d}, v {dv}) not in the {body} "
                         f"body's {pairs} ({dtype})")
    return body


def check_tma_alignment(**ptrs: int) -> None:
    """Raise unless every address (``name=data_ptr()``) is TMA-aligned."""
    for name, ptr in ptrs.items():
        if ptr % TMA_ALIGN:
            raise ValueError(f"{name} at {ptr:#x} is not {TMA_ALIGN}-byte "
                             "aligned, as the wgmma body's TMA loads need")


def tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on a TMA-aligned address: ``t`` itself where it
    already is, else a fresh copy (autograd may hand the backward a strided
    or offset cotangent)."""
    t = t.contiguous()
    return t if t.data_ptr() % TMA_ALIGN == 0 else t.clone()


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int) -> str:
    """Raise unless q, k, v fit one K11 call; return the body that takes
    it."""
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"q (B, Sq, H, D), k (B, Sk, Kv, D) and v (B, Sk, "
                         f"Kv, Dv) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    kv, dv = k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)} "
                         "(same B and D, H a multiple of Kv)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    body = kernel_body(q.dtype, d, dv)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    return body


def _clipped_sum(a: int, c: int, r0: int, r1: int) -> int:
    """The sum of max(0, a + c r) over r in [r0, r1), c in {-1, 0, 1}."""
    if c == 1:
        r0 = max(r0, 1 - a)
    elif c == -1:
        r1 = min(r1, a)
    elif a <= 0:
        return 0
    if r1 <= r0:
        return 0
    n = r1 - r0
    return n * a + c * (r0 + r1 - 1) * n // 2


def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (row, column) pairs attention's mask keeps: the causal mask
    aligned at position 0 (column <= row), ``window`` > 0 keeping columns
    past row - window. Closed form: each row keeps hi - lo + 1 columns
    (hi = min(row, Sk - 1) or Sk - 1, lo = max(0, row - window + 1) or 0),
    linear in the row between the points where hi or lo change form."""
    cuts = {0, sq}
    if causal:
        cuts.add(min(max(sk, 0), sq))
    if window > 0:
        cuts.add(min(window, sq))
    cuts = sorted(cuts)
    total = 0
    for r0, r1 in zip(cuts, cuts[1:]):
        # hi - lo + 1 = a + c r on [r0, r1)
        a, c = (0, 1) if causal and r0 < sk else (sk - 1, 0)
        if window > 0 and r0 >= window:
            a, c = a + window - 1, c - 1
        total += _clipped_sum(a + 1, c, r0, r1)
    return total


def _dims(q_shape, k_shape, v_shape):
    (b, sq, h, d), (_, sk, kv, _), dv = q_shape, k_shape, v_shape[-1]
    return b, sq, sk, h, kv, d, dv


def k11_work(q_shape, k_shape, v_shape, esz: int, causal: bool,
             window: int = 0, with_lse: bool = False):
    """(operations, bytes) K11's function needs: 2 (D + Dv) operations per
    kept pair; q read, the output (and the f32 lse) written, and the k / v
    rows some query sees (under the causal mask none past key Sq - 1)."""
    b, sq, sk, h, kv, d, dv = _dims(q_shape, k_shape, v_shape)
    live = min(sk, sq) if causal else sk
    flops = 2 * (d + dv) * b * h * attention_pairs(sq, sk, causal, window)
    nbytes = (esz * (b * sq * h * (d + dv) + b * live * kv * (d + dv))
              + (4 * b * h * sq if with_lse else 0))
    return flops, nbytes


def k13_work(q_shape, k_shape, v_shape, esz: int, causal: bool,
             window: int = 0):
    """(operations, bytes) of K13 (dQ and each row's Delta): 2 (2 D + Dv)
    operations per kept pair; q, the live k / v rows, o, dO and lse read,
    dq and Delta written."""
    b, sq, sk, h, kv, d, dv = _dims(q_shape, k_shape, v_shape)
    live = min(sk, sq) if causal else sk
    n_pairs = b * h * attention_pairs(sq, sk, causal, window)
    q_el, o_el = b * sq * h * d, b * sq * h * dv
    return (2 * (2 * d + dv) * n_pairs,
            esz * (2 * q_el + b * live * kv * (d + dv) + 2 * o_el)
            + 8 * b * h * sq)


def k12_work(q_shape, k_shape, v_shape, esz: int, causal: bool,
             window: int = 0):
    """(operations, bytes) of K12 (dK, dV): 2 (2 D + 2 Dv) operations per
    kept pair; q, dO, k, v, lse and Delta read, dk and dv written."""
    b, sq, sk, h, kv, d, dv = _dims(q_shape, k_shape, v_shape)
    n_pairs = b * h * attention_pairs(sq, sk, causal, window)
    q_el, o_el = b * sq * h * d, b * sq * h * dv
    return (2 * (2 * d + 2 * dv) * n_pairs,
            esz * (q_el + o_el + 2 * b * sk * kv * (d + dv)) + 8 * b * h * sq)


def _scale(d: int) -> float:
    return float(np.float32(d ** -0.5))


def _k11(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         window: int, with_lse: bool):
    """K11 on CUDA tensors, the plain version on CPU ones, the outputs
    alone on meta ones: the output, and with ``with_lse`` also the (B, H,
    Sq) f32 log-sum-exp. The work is booked (:func:`k11_work`)."""
    body = _check_args(q, k, v, window)
    with _build.booking("flash_attention", lambda: k11_work(
            q.shape, k.shape, v.shape, q.element_size(), causal, window,
            with_lse)):
        return _k11_call(q, k, v, causal, window, with_lse, body)


def _k11_call(q, k, v, causal, window, with_lse, body):
    if q.is_meta:
        b, sq, h, _ = q.shape
        out = q.new_empty((b, sq, h, v.shape[3]))
        lse = (q.new_empty((b, h, sq), dtype=torch.float32) if with_lse
               else None)
        return (out, lse) if with_lse else out
    if not q.is_cuda:
        # contiguous, as K11's and the meta branch's outputs are, so that
        # what follows runs the same ops on every device
        res = flash_attention_ref(q, k, v, causal=causal, window=window,
                                  return_lse=with_lse)
        return (tuple(t.contiguous() for t in res) if with_lse
                else res.contiguous())
    b, sq, h, d = q.shape
    sk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check(t, name, q.dtype)
    out = q.new_empty((b, sq, h, dv))
    lse = (q.new_empty((b, h, sq), dtype=torch.float32) if with_lse
           else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    if sk == 0:
        raise ValueError("k and v hold no positions")
    if body == "wgmma":
        check_tma_alignment(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr())
    _build.launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), None if lse is None else lse.data_ptr(), b,
                  sq, sk, h, kv, d, dv, int(causal), window,
                  int(q.dtype == torch.bfloat16), _scale(d))
    return (out, lse) if with_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Sk, Kv, D); v: (B, Sk, Kv, Dv), one dtype
    (f32 or bf16) on one device -> (B, Sq, H, Dv) in q's dtype, f32
    accumulation, the scores scaled by D^-1/2. The causal mask is aligned at
    position 0 (``cols <= rows``); ``window`` > 0 keeps ``cols > rows -
    window``. Differentiable through :class:`FlashAttention` when grad mode
    is on and q, k or v requires a gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return _k11(q, k, v, causal, window, with_lse=False)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """As :func:`flash_attention` (never through autograd), returning
    ``(out, lse)``: lse (B, H, Sq) f32 is each row's log-sum-exp of the
    masked, scaled scores in natural-log units, as the backward takes it."""
    return _k11(q, k, v, causal, window, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """The gradients (dq, dk, dv), in q's dtype, of :func:`flash_attention`
    at (q, k, v) for the output cotangent ``do`` (B, Sq, H, Dv), from the
    forward's output ``o`` and ``lse`` (:func:`flash_attention_fwd`). CUDA
    tensors: K13 (dQ, and each row's rowsum(dO o O) for K12) then K12 (dK,
    dV), by the body :data:`BWD_BODIES` names for the dtype (bf16 needs q,
    k, v, o and do TMA-aligned); CPU tensors:
    ``ref.flash_attention_bwd_ref``."""
    _check_args(q, k, v, window)  # K11's dtypes and pairs, the backward's
    body = BWD_BODIES[q.dtype][0]
    b, sq, h, d = q.shape
    sk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (tuple(o.shape) != (b, sq, h, dv) or tuple(do.shape) != tuple(o.shape)
            or tuple(lse.shape) != (b, h, sq)):
        raise ValueError(f"o and do (B, Sq, H, Dv) = {(b, sq, h, dv)} and lse "
                         f"(B, H, Sq) expected, got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and do must be {q.dtype}, got {o.dtype}, "
                         f"{do.dtype}")
    if not (q.device == o.device == do.device == lse.device):
        raise ValueError(f"q on {q.device}, o on {o.device}, do on "
                         f"{do.device}, lse on {lse.device}")
    esz = q.element_size()
    with _build.booking("flash_attention_bwd_dq", lambda: k13_work(
            q.shape, k.shape, v.shape, esz, causal, window)), \
            _build.booking("flash_attention_bwd_dkdv", lambda: k12_work(
                q.shape, k.shape, v.shape, esz, causal, window)):
        return _bwd_call(q, k, v, o, lse, do, causal, window, body)


def _bwd_call(q, k, v, o, lse, do, causal, window, body):
    if q.is_meta:
        return tuple(torch.empty_like(t) for t in (q, k, v))
    b, sq, h, d = q.shape
    sk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    if not q.is_cuda:  # contiguous, as K13's / K12's outputs are
        return tuple(t.contiguous() for t in flash_attention_bwd_ref(
            q, k, v, o, lse, do, causal=causal, window=window))
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _build.check(t, name, q.dtype)
    _build.check(lse, "lse", torch.float32)
    if body == "wgmma":
        check_tma_alignment(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                            o=o.data_ptr(), do=do.data_ptr())
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dvv.zero_()
    delta = q.new_empty((b, h, sq), dtype=torch.float32)
    sizes = (b, sq, sk, h, kv, d, dv, int(causal), window,
             int(q.dtype == torch.bfloat16), _scale(d))
    _build.launch("flash_attention_bwd_dq", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                  dq.data_ptr(), delta.data_ptr(), *sizes)
    _build.launch("flash_attention_bwd_dkdv", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dk.data_ptr(), dvv.data_ptr(), *sizes)
    return dq, dk, dvv


class FlashAttention(torch.autograd.Function):
    """K11 with its log-sum-exp forward; K13 then K12 backward (the plain
    versions on CPU tensors). q, k and v get gradients; causal and window
    none."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _k11(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, tma_ready(do),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
