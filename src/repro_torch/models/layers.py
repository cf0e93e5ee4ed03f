"""Shared neural building blocks (port of ``repro/models/layers.py``; pure
functions over param dicts).

The casts sit where the JAX package puts them, since they decide the bf16
result: norms run in f32 and cast back, RoPE runs in f32, SwiGLU takes the
gate's ``silu`` in f32 and casts it to the activation dtype before the
product. Only what the ported GQA configs run is here: RMSNorm, SwiGLU and
tied or untied embeddings. LayerNorm, the ReLU / GELU FFNs and
``cross_entropy`` come with the configs and the training step that use
them (ROADMAP.md Queue 1, LLM side).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.pspec import ParamSpec, torch_dtype


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1, LLM side)")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_specs(cfg) -> Dict[str, ParamSpec]:
    if cfg.norm != "rmsnorm":
        raise _unported(f"norm {cfg.norm!r}")
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones",
                               torch_dtype(cfg.param_dtype))}


def apply_norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm != "rmsnorm":
        raise _unported(f"norm {cfg.norm!r}")
    return rms_norm(x, p["scale"])


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs  # (..., S, half)
    sin = torch.sin(ang)[..., None, :]  # (..., S, 1, half)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def ffn_specs(cfg) -> Dict[str, ParamSpec]:
    if cfg.act != "swiglu":
        raise _unported(f"act {cfg.act!r}")
    d, d_ff = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    return {
        "wi": ParamSpec((d, d_ff), ("embed", "mlp"), "scaled", dt),
        "wg": ParamSpec((d, d_ff), ("embed", "mlp"), "scaled", dt),
        "wo": ParamSpec((d_ff, d), ("mlp", "embed"), "scaled", dt),
    }


def apply_ffn(cfg, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.act != "swiglu":
        raise _unported(f"act {cfg.act!r}")
    h = torch.matmul(x, p["wi"])
    g = torch.matmul(x, p["wg"])
    h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    return torch.matmul(h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_specs(cfg) -> Dict[str, ParamSpec]:
    dt = torch_dtype(cfg.param_dtype)
    sp = {"tok": ParamSpec((cfg.padded_vocab, cfg.d_model),
                           ("vocab", "embed"), "embed", dt)}
    if not cfg.tie_embeddings:
        sp["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                  ("embed", "vocab"), "scaled", dt)
    return sp


def embed_tokens(cfg, p, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: integer ids of any shape -> (*tokens.shape, d_model)."""
    flat = p["tok"].index_select(0, tokens.reshape(-1))
    return flat.reshape(*tokens.shape, flat.shape[-1])


def logits(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) -> (..., padded_vocab), through the token table when the
    embeddings are tied, else through ``unembed`` (d, V)."""
    if cfg.tie_embeddings:
        return torch.matmul(x, p["tok"].T)
    return torch.matmul(x, p["unembed"])
