"""Encoder-decoder transformer (port of ``repro/models/encdec.py``): the
seamless-m4t backbone. [arXiv:2308.11596]

The modality frontend (mel-spectrogram + conv feature extractor) is the one
allowed stub: the encoder takes precomputed frame embeddings of shape
(B, S_src, d_model). The encoder's self-attention is bidirectional and the
cross-attention plain projections, neither with RoPE nor biases; the
decoder's self-attention is :func:`attention.gqa_forward` (RoPE, causal),
and in decode :func:`attention.gqa_decode`'s einsum readout, as in the JAX
package. Every other attention goes through :func:`attention.flash_attention`
with ``causal=False`` (kernel K11 on the card): the encoder at Sq = Sk =
S_src, the forward's cross-attention at Sq = S_tgt against Sk = S_src, and
a decode step's at Sq = 1.

Each encoder and decoder layer of the forward is one region of
``models/remat.py`` (``cfg.remat``); a decoder layer's region holds its
cross keys and values, computed from ``enc_out`` inside it, as in the JAX
package.

Parameters stay stacked over layers (``enc_layers`` and ``dec_layers``,
``(L, ...)`` as in the JAX package; each loop over layers takes them apart
once with :func:`transformer.unstack`). The decode state is preallocated:
the self-attention caches ``(L, B, size, Kv, D)`` as in :mod:`transformer`,
and the cross keys and values ``(L, B, S_src, Kv, D)`` that
:func:`prefill_cross` writes in place; ``pos`` is a Python int.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.common import pspec
from repro_torch.common.device import DeviceLike
from repro_torch.common.pspec import torch_dtype
from repro_torch.models import attention, layers, remat
from repro_torch.models.transformer import unstack


def _enc_layer_specs(cfg) -> Dict[str, Any]:
    return {
        "ln1": layers.norm_specs(cfg),
        "attn": attention.gqa_specs(cfg),
        "ln2": layers.norm_specs(cfg),
        "ffn": layers.ffn_specs(cfg),
    }


def _dec_layer_specs(cfg) -> Dict[str, Any]:
    return {
        "ln1": layers.norm_specs(cfg),
        "self_attn": attention.gqa_specs(cfg),
        "ln_x": layers.norm_specs(cfg),
        "cross": attention.gqa_specs(cfg),
        "ln2": layers.norm_specs(cfg),
        "ffn": layers.ffn_specs(cfg),
    }


def param_specs(cfg) -> Dict[str, Any]:
    if cfg.n_enc_layers <= 0:
        raise ValueError(f"{cfg.arch_id}: encdec requires n_enc_layers > 0, "
                         f"got {cfg.n_enc_layers}")
    return {
        "embed": layers.embed_specs(cfg),
        "enc_layers": pspec.stack(_enc_layer_specs(cfg), cfg.n_enc_layers),
        "enc_ln_f": layers.norm_specs(cfg),
        "dec_layers": pspec.stack(_dec_layer_specs(cfg), cfg.n_layers),
        "ln_f": layers.norm_specs(cfg),
    }


def _cross_kv(p, enc_out: torch.Tensor):
    """The cross-attention's keys and values over the encoder states:
    (B, S_src, Kv, D) each, no RoPE."""
    return attention._proj(enc_out, p["wk"]), attention._proj(enc_out, p["wv"])


def _cross_attend(p, x: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """x: (B, Sq, d) attends to every encoder position (no mask)."""
    q = attention._proj(x, p["wq"])
    o = attention.flash_attention(q, k, v, causal=False)
    return attention._out_proj(o, p["wo"])


def encode(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_src, d_model) stub embeddings -> encoder states in
    ``cfg.dtype``."""
    x = frames.to(torch_dtype(cfg.dtype))

    def body(x, lp):
        a = lp["attn"]
        h = layers.apply_norm(cfg, lp["ln1"], x)
        q, k, v = (attention._proj(h, a[w]) for w in ("wq", "wk", "wv"))
        o = attention.flash_attention(q, k, v, causal=False)
        x = x + attention._out_proj(o, a["wo"])
        return x + layers.apply_ffn(cfg, lp["ffn"],
                                    layers.apply_norm(cfg, lp["ln2"], x))

    layer = remat.checkpointed(cfg, body)
    for lp in unstack(params["enc_layers"]):
        x = layer(x, lp)
    return layers.apply_norm(cfg, params["enc_ln_f"], x)


def forward(cfg, params, batch: Dict[str, torch.Tensor], *,
            window: Optional[int] = None, last_only: bool = False):
    """batch: ``frames`` (B, S_src, d) and ``tokens`` (B, S_tgt) -> decoder
    logits (B, S_tgt, padded_vocab) and a zero aux loss."""
    w = cfg.sliding_window if window is None else window
    enc_out = encode(cfg, params, batch["frames"])
    x = layers.embed_tokens(cfg, params["embed"], batch["tokens"]).to(
        torch_dtype(cfg.dtype))

    def body(x, enc_out, lp):
        h = layers.apply_norm(cfg, lp["ln1"], x)
        x = x + attention.gqa_forward(cfg, lp["self_attn"], h, window=w)
        h = layers.apply_norm(cfg, lp["ln_x"], x)
        k, v = _cross_kv(lp["cross"], enc_out)
        x = x + _cross_attend(lp["cross"], h, k, v)
        return x + layers.apply_ffn(cfg, lp["ffn"],
                                    layers.apply_norm(cfg, lp["ln2"], x))

    layer = remat.checkpointed(cfg, body)
    for lp in unstack(params["dec_layers"]):
        x = layer(x, enc_out, lp)
    if last_only:
        x = x[:, -1:]
    x = layers.apply_norm(cfg, params["ln_f"], x)
    return (layers.logits(cfg, params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg, batch: int, max_len: int, *, window: int = 0,
                      src_len: int = 0, device: DeviceLike = None):
    """Self-attention caches (zeros) stacked over the decoder's layers, the
    cross keys and values of ``src_len`` positions (``max_len`` when 0;
    zeros until :func:`prefill_cross`), and the position counter."""
    src_len = src_len or max_len
    one = attention.init_kv_cache(cfg, batch, max_len, window=window,
                                  device=device)
    n, dev = cfg.n_layers, one["k"].device
    cross = (n, batch, src_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    return {
        "self": {k: torch.zeros((n,) + tuple(a.shape), dtype=a.dtype,
                                device=dev) for k, a in one.items()},
        "cross_k": torch.zeros(cross, dtype=dt, device=dev),
        "cross_v": torch.zeros(cross, dtype=dt, device=dev),
        "pos": 0,
    }


def prefill_cross(cfg, params, state, frames: torch.Tensor):
    """Run the encoder on ``frames`` (B, S_src, d) and write every decoder
    layer's cross keys and values into the state's caches in place; S_src
    must be the caches' length."""
    src_len = state["cross_k"].shape[2]
    if frames.shape[1] != src_len:
        raise ValueError(f"{frames.shape[1]} frames for cross caches of "
                         f"{src_len} positions")
    enc_out = encode(cfg, params, frames)
    for i, lp in enumerate(unstack(params["dec_layers"])):
        k, v = _cross_kv(lp["cross"], enc_out)
        state["cross_k"][i] = k
        state["cross_v"][i] = v
    return dict(state)


def decode_step(cfg, params, state, tokens: torch.Tensor, *, window: int = 0):
    """One-token decode. tokens: (B,) ints. Returns (logits (B, V),
    new_state); the self-attention caches are updated in place."""
    pos = state["pos"]
    x = layers.embed_tokens(cfg, params["embed"], tokens[:, None]).to(
        torch_dtype(cfg.dtype))
    for i, lp in enumerate(unstack(params["dec_layers"])):
        h = layers.apply_norm(cfg, lp["ln1"], x)
        cache = {k: a[i] for k, a in state["self"].items()}
        h, _ = attention.gqa_decode(cfg, lp["self_attn"], h, cache, pos,
                                    window=window)
        x = x + h
        h = layers.apply_norm(cfg, lp["ln_x"], x)
        x = x + _cross_attend(lp["cross"], h, state["cross_k"][i],
                              state["cross_v"][i])
        x = x + layers.apply_ffn(cfg, lp["ffn"],
                                 layers.apply_norm(cfg, lp["ln2"], x))
    x = layers.apply_norm(cfg, params["ln_f"], x)
    lg = layers.logits(cfg, params["embed"], x)[:, 0]
    return lg, dict(state, pos=pos + 1)
