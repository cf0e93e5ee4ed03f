"""Shared neural building blocks (port of ``repro/models/layers.py``; pure
functions over param dicts).

The casts sit where the JAX package puts them, since they decide the bf16
result: norms run in f32 and cast back, RoPE runs in f32, SwiGLU takes the
gate's ``silu`` in f32 and casts it to the activation dtype before the
product, the ReLU FFN clamps in the activation dtype. Only what the ported
configs run is here: RMSNorm and LayerNorm, the SwiGLU and ReLU FFNs, tied
or untied embeddings, and the training loss :func:`cross_entropy`. The
GELU FFN (no config of the JAX package sets it) is not ported (ROADMAP.md
Queue 1, LLM side).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.pspec import ParamSpec, torch_dtype
from repro_torch.models.remat import matmul


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1, LLM side)")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_specs(cfg) -> Dict[str, ParamSpec]:
    """RMSNorm's scale; LayerNorm (``cfg.norm == "layernorm"``) adds a
    bias."""
    d, dt = cfg.d_model, torch_dtype(cfg.param_dtype)
    sp = {"scale": ParamSpec((d,), ("embed",), "ones", dt)}
    if cfg.norm == "layernorm":
        sp["bias"] = ParamSpec((d,), ("embed",), "zeros", dt)
    return sp


def apply_norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm where the config asks for it and ``p`` has its bias, else
    RMSNorm (the JAX package's rule); both in f32, cast back."""
    if cfg.norm == "layernorm" and "bias" in p:
        xf = x.float()
        y = torch.nn.functional.layer_norm(
            xf, xf.shape[-1:], p["scale"].float(), p["bias"].float(), 1e-6)
        return y.to(x.dtype)
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

def _check_act(cfg) -> None:
    if cfg.act not in ("swiglu", "relu"):
        raise _unported(f"act {cfg.act!r}")


def ffn_specs(cfg, d_ff: int | None = None) -> Dict[str, ParamSpec]:
    """``wi`` / ``wo``, and SwiGLU's gate ``wg``; ``d_ff`` defaults to the
    config's (the MoE's shared experts pass theirs)."""
    _check_act(cfg)
    d, d_ff = cfg.d_model, d_ff or cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    sp = {"wi": ParamSpec((d, d_ff), ("embed", "mlp"), "scaled", dt),
          "wo": ParamSpec((d_ff, d), ("mlp", "embed"), "scaled", dt)}
    if cfg.act == "swiglu":
        sp["wg"] = ParamSpec((d, d_ff), ("embed", "mlp"), "scaled", dt)
    return sp


def apply_ffn(cfg, p, x: torch.Tensor) -> torch.Tensor:
    _check_act(cfg)
    h = matmul(x, p["wi"])
    if cfg.act == "swiglu":
        g = matmul(x, p["wg"])
        h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    else:  # relu, in the activation dtype (jnp.maximum(h, 0))
        h = torch.relu(h)
    return matmul(h, p["wo"])


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


def cross_entropy(logits_: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is >= 0 (labels < 0
    are masked): f32 log-sum-exp minus the gold logit, summed and divided by
    ``max(count, 1)``, as the JAX package computes it. ``vocab_size`` is
    taken and unused, as there."""
    lf = logits_.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - gold) * mask) / torch.clamp_min(mask.sum(), 1.0)
