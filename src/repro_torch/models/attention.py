"""Attention (port of ``repro/models/attention.py``): GQA, full or
sliding-window, with optional QKV biases and QK norms, and its decode cache
in the activation dtype or in int8; and deepseek-v2's multi-head latent
attention (MLA).

* :func:`flash_attention` is the attention core of the prefills, of the
  encoder-decoder's encoder and of its cross-attention (``causal=False``,
  Sq != Sk, Sq = 1 in decode) and of MLA's expanded forward (v narrower
  than q and k). It sends CUDA tensors to kernel K11
  (``kernels/flash_attention/ops.py``) and CPU tensors to its plain
  version, as the JAX models' jnp flash has the same arithmetic as the
  Pallas kernel (``tests/test_kernels.py`` holds the two within 2e-5). It
  takes no ``chunk_q`` / ``chunk_k`` / ``q_offset``: every caller passes
  ``q_offset=0``, and the tiles are the kernel's own choice.
* Decode caches are preallocated and written in place at ``pos`` (a ring
  buffer of ``window`` slots when a window is set). Keys are stored
  post-RoPE, so readout needs only a validity mask. The decode readout is
  plain torch (einsum, softmax, einsum), as in the JAX package.
* The int8 cache holds codes ``round(x / scale)`` clipped to +-127, with one
  absmax scale per (token, kv head). Scores factorize exactly, so the k
  scales multiply the dots and the v scales the probabilities.
* MLA compresses k and v into a latent ``ckv`` (rank ``kv_lora_rank``) and
  one rope key shared by every head. The forward expands them per head and
  runs :func:`flash_attention` at qk dim ``qk_nope_dim + qk_rope_dim`` and v
  dim ``v_head_dim`` (192 / 128 in deepseek-v2), v unpadded: the JAX
  package pads v to the qk dim for its shared kernel and slices the
  padding's zero columns off again. The decode is the absorbed form: ``W_uk``
  folded into the query and ``W_uv`` into the output, so the cache holds only
  ``ckv`` and the rope key, written in place at ``pos``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.pspec import ParamSpec, torch_dtype
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import remat
from repro_torch.models.layers import apply_rope, rms_norm

Cache = Dict[str, torch.Tensor]

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Sk, Kv, D); v: (B, Sk, Kv, Dv) -> (B, Sq, H,
    Dv) in q's dtype, the causal mask aligned at position 0, the scores
    scaled by D^-1/2."""
    return flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=causal,
                                     window=window)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_specs(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    dt = torch_dtype(cfg.param_dtype)
    sp = {
        "wq": ParamSpec((d, cfg.n_heads, hd), ("embed", "heads", "head_dim"),
                        "scaled", dt, fan_in=d),
        "wk": ParamSpec((d, cfg.n_kv_heads, hd),
                        ("embed", "kv_heads", "head_dim"), "scaled", dt,
                        fan_in=d),
        "wv": ParamSpec((d, cfg.n_kv_heads, hd),
                        ("embed", "kv_heads", "head_dim"), "scaled", dt,
                        fan_in=d),
        "wo": ParamSpec((cfg.n_heads, hd, d), ("heads", "head_dim", "embed"),
                        "scaled", dt, fan_in=cfg.n_heads * hd),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((cfg.n_heads, hd), ("heads", "head_dim"),
                             "zeros", dt)
        sp["bk"] = ParamSpec((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"),
                             "zeros", dt)
        sp["bv"] = ParamSpec((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"),
                             "zeros", dt)
    if cfg.qk_norm:
        sp["q_norm"] = ParamSpec((hd,), ("head_dim",), "ones", dt)
        sp["k_norm"] = ParamSpec((hd,), ("head_dim",), "ones", dt)
    return sp


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return remat.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(cfg, p, x: torch.Tensor, positions: torch.Tensor):
    """Projections, then the biases, then the QK norms, then RoPE (the JAX
    package's order)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return remat.matmul(o.flatten(-2), wo.reshape(h * k, d))


def gqa_forward(cfg, p, x: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Training / prefill self-attention. x: (B, S, d)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project_qkv(cfg, p, x, positions)
    return _out_proj(flash_attention(q, k, v, window=window), p["wo"])


def init_kv_cache(cfg, batch: int, max_len: int, window: int = 0,
                  device: DeviceLike = None) -> Cache:
    """One layer's cache (``transformer.init_decode_state`` stacks them)."""
    size = min(window, max_len) if window > 0 else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt, dev = torch_dtype(cfg.dtype), resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _slot_and_valid(size: int, pos: int, window: int, device):
    """The cache slot that position ``pos`` writes, and which of the
    ``size`` slots hold a position at or before it."""
    j = torch.arange(size, device=device)
    if window > 0:
        # slot j holds absolute position pos - ((pos - j) mod size)
        return pos % size, (pos - ((pos - j) % size)) >= 0
    return pos, j <= pos


def gqa_decode(cfg, p, x: torch.Tensor, cache: Cache, pos: int, *,
               window: int = 0):
    """One-token decode. x: (B, 1, d); pos: the current position.

    Writes this token's keys and values into ``cache`` in place (slot
    ``pos``, or ``pos % size`` in a window's ring buffer) and returns
    ``(out, cache)``."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)  # (B, 1, H or Kv, D)

    slot, valid = _slot_and_valid(cache["k"].shape[1], pos, window, x.device)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    ck, cv = cache["k"], cache["v"]

    kv = cfg.n_kv_heads
    qh = q.reshape(b, kv, cfg.n_heads // kv, -1)
    # the dots in f32 (preferred_element_type=f32 in the JAX package)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), ck.float())
    s = s * (q.shape[-1] ** -0.5)
    # masked_fill, not torch.where with a fresh scalar tensor: building that
    # tensor on the card is a pageable host copy, which waits for the stream
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w.to(cv.dtype).float(), cv.float())
    o = o.reshape(b, 1, cfg.n_heads, -1).to(x.dtype)
    return _out_proj(o, p["wo"]), cache


# ---------------------------------------------------------------------------
# Int8-quantized KV cache
# ---------------------------------------------------------------------------

def init_kv_cache_int8(cfg, batch: int, max_len: int, window: int = 0,
                       device: DeviceLike = None) -> Cache:
    """One layer's int8 cache: codes and one f32 scale per (token, kv
    head)."""
    size = min(window, max_len) if window > 0 else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.resolved_head_dim)
    dev = resolve_device(device)

    def zeros(shp, dt):
        return torch.zeros(shp, dtype=dt, device=dev)

    return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
            "k_scale": zeros(shape[:3], torch.float32),
            "v_scale": zeros(shape[:3], torch.float32)}


def _quantize_kv(x: torch.Tensor):
    """x: (B, 1, K, D) -> int8 codes and the per-(token, head) absmax scale.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-6) / 127.0  # (B, 1, K)
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def gqa_decode_int8(cfg, p, x: torch.Tensor, cache: Cache, pos: int, *,
                    window: int = 0):
    """One-token decode against the int8 cache, with :func:`gqa_decode`'s
    contract."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)

    slot, valid = _slot_and_valid(cache["k"].shape[1], pos, window, x.device)
    cache["k"][:, slot] = kq[:, 0]
    cache["v"][:, slot] = vq[:, 0]
    cache["k_scale"][:, slot] = ks[:, 0]
    cache["v_scale"][:, slot] = vs[:, 0]

    kv = cfg.n_kv_heads
    qh = q.reshape(b, kv, cfg.n_heads // kv, -1)
    # the dots in f32 (codes are exact in bf16 and f32 alike)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), cache["k"].float())
    s = s * cache["k_scale"].transpose(1, 2)[:, :, None, :]  # k scales back in
    s = s * (q.shape[-1] ** -0.5)
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    wv = w * cache["v_scale"].transpose(1, 2)[:, :, None, :]  # v scales in
    o = torch.einsum("bkgs,bskd->bkgd", wv.to(x.dtype).float(),
                     cache["v"].float())
    o = o.reshape(b, 1, cfg.n_heads, -1).to(x.dtype)
    return _out_proj(o, p["wo"]), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_specs(cfg) -> Dict[str, ParamSpec]:
    """The query's low-rank path (``wdq``, ``q_norm``, ``wuq``), the latent
    k / v path (``wdkv``, ``kv_norm``, ``wuk``, ``wuv``), the shared rope
    key ``wkr`` and ``wo``. Every config sets ``q_lora_rank``; the direct
    query projection of ``q_lora_rank = 0`` raises."""
    if not cfg.q_lora_rank:
        raise NotImplementedError(
            "MLA with q_lora_rank = 0 (a direct query projection) is not "
            "ported: no config sets it (ROADMAP.md Queue 1, LLM side)")
    d, h = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = torch_dtype(cfg.param_dtype)
    return {
        "wdq": ParamSpec((d, r_q), ("embed", "q_lora"), "scaled", dt),
        "q_norm": ParamSpec((r_q,), ("q_lora",), "ones", dt),
        "wuq": ParamSpec((r_q, h, nope + rope),
                         ("q_lora", "heads", "head_dim"), "scaled", dt),
        "wdkv": ParamSpec((d, r_kv), ("embed", "kv_lora"), "scaled", dt),
        "kv_norm": ParamSpec((r_kv,), ("kv_lora",), "ones", dt),
        "wkr": ParamSpec((d, rope), ("embed", "head_dim"), "scaled", dt),
        "wuk": ParamSpec((r_kv, h, nope), ("kv_lora", "heads", "head_dim"),
                         "scaled", dt),
        "wuv": ParamSpec((r_kv, h, vdim), ("kv_lora", "heads", "head_dim"),
                         "scaled", dt),
        "wo": ParamSpec((h, vdim, d), ("heads", "head_dim", "embed"),
                        "scaled", dt, fan_in=h * vdim),
    }


def _mla_q(cfg, p, x: torch.Tensor, positions: torch.Tensor):
    """x (B, S, d) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope) after
    RoPE."""
    cq = rms_norm(remat.matmul(x, p["wdq"]), p["q_norm"])
    q = _proj(cq, p["wuq"])
    nope = cfg.qk_nope_dim
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_latent(cfg, p, x: torch.Tensor, positions: torch.Tensor):
    """x (B, S, d) -> ckv (B, S, kv_lora_rank), normed, and the shared rope
    key (B, S, rope) after RoPE (taken as one head, then squeezed)."""
    ckv = rms_norm(remat.matmul(x, p["wdkv"]), p["kv_norm"])
    k_rope = remat.matmul(x, p["wkr"])[:, :, None]  # (B, S, 1, rope)
    return ckv, apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]


def mla_forward(cfg, p, x: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Training / prefill MLA in the expanded form. x: (B, S, d). k is
    ``[k_nope, k_rope]`` with the one rope key repeated over the heads; v
    keeps its own ``v_head_dim`` columns through :func:`flash_attention`,
    whose scale is the qk dim's."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = _proj(ckv, p["wuk"])
    v = _proj(ckv, p["wuv"])
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        b, s, cfg.n_heads, cfg.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return _out_proj(flash_attention(q, k, v, window=window), p["wo"])


def init_mla_cache(cfg, batch: int, max_len: int, *,
                   device: DeviceLike = None) -> Cache:
    """One layer's latent cache: ``ckv`` (B, max_len, kv_lora_rank) and the
    rope keys ``kr`` (B, max_len, qk_rope_dim), in the activation dtype."""
    dt, dev = torch_dtype(cfg.dtype), resolve_device(device)
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dt,
                               device=dev),
            "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dt,
                              device=dev)}


def mla_decode(cfg, p, x: torch.Tensor, cache: Cache, pos: int):
    """One-token absorbed-form decode: score and readout in latent space.
    x: (B, 1, d). Writes this token's ``ckv`` and rope key into ``cache`` in
    place at ``pos`` and returns ``(out, cache)``. The dots run in f32 where
    the JAX package asks for f32 results, with its casts between them."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)  # (B, 1, H, *)
    ckv_new, kr_new = _mla_latent(cfg, p, x, positions)  # (B, 1, r / rope)
    cache["ckv"][:, pos] = ckv_new[:, 0]
    cache["kr"][:, pos] = kr_new[:, 0]
    ckv, kr = cache["ckv"], cache["kr"]

    # W_uk absorbed into the query: (B, H, r)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0].float(),
                         p["wuk"].float())
    s = torch.einsum("bhr,bsr->bhs", q_lat.to(ckv.dtype).float(),
                     ckv.float())
    s = s + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(), kr.float())
    s = s * ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", w.to(ckv.dtype).float(), ckv.float())
    o = torch.einsum("bhr,rhk->bhk", ctx.to(p["wuv"].dtype).float(),
                     p["wuv"].float())
    return _out_proj(o.to(x.dtype)[:, None], p["wo"]), cache
