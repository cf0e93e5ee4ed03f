"""Attention (port of ``repro/models/attention.py``): GQA, full or
sliding-window, with its decode cache.

* :func:`flash_attention` is the prefill's attention core. It sends CUDA
  tensors to kernel K11 (``kernels/flash_attention/ops.py``) and CPU tensors
  to its plain version, as the JAX models' jnp flash has the same
  arithmetic as the Pallas kernel (``tests/test_kernels.py`` holds the two
  within 2e-5). It takes no ``chunk_q`` / ``chunk_k`` / ``q_offset``: every
  caller passes ``q_offset=0``, and the tiles are the kernel's own choice.
* Decode caches are preallocated and written in place at ``pos`` (a ring
  buffer of ``window`` slots when a window is set). Keys are stored
  post-RoPE, so readout needs only a validity mask. The decode readout is
  plain torch (einsum, softmax, einsum), as in the JAX package.

MLA, the int8 KV cache, QKV biases and QK norms come with the configs that
use them (ROADMAP.md Queue 1, LLM side).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.pspec import ParamSpec, torch_dtype
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope

Cache = Dict[str, torch.Tensor]

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Kv, D) -> (B, Sq, H, D) in q's dtype,
    the causal mask aligned at position 0."""
    return flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=causal,
                                     window=window)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def _check_gqa(cfg) -> None:
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError("QKV biases and QK norms are not ported yet "
                                  "(ROADMAP.md Queue 1, LLM side)")


def gqa_specs(cfg) -> Dict[str, ParamSpec]:
    _check_gqa(cfg)
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    dt = torch_dtype(cfg.param_dtype)
    return {
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


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(cfg, p, x: torch.Tensor, positions: torch.Tensor):
    _check_gqa(cfg)
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return torch.matmul(o.flatten(-2), wo.reshape(h * k, d))


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


def gqa_decode(cfg, p, x: torch.Tensor, cache: Cache, pos: int, *,
               window: int = 0):
    """One-token decode. x: (B, 1, d); pos: the current position.

    Writes this token's keys and values into ``cache`` in place (slot
    ``pos``, or ``pos % size`` in a window's ring buffer) and returns
    ``(out, cache)``."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)  # (B, 1, H or Kv, D)

    size = cache["k"].shape[1]
    slot = pos % size if window > 0 else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    ck, cv = cache["k"], cache["v"]

    j = torch.arange(size, device=x.device)
    if window > 0:
        # slot j holds absolute position pos - ((pos - j) mod size)
        valid = (pos - ((pos - j) % size)) >= 0
    else:
        valid = j <= pos

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
