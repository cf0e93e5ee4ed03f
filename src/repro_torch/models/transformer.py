"""Dense decoder-only transformer (port of ``repro/models/transformer.py``,
the ``dense`` family with GQA and a native-dtype KV cache).

Parameters stay stacked over layers, ``(L, ...)`` as in the JAX package, so
a weight tree crosses between the packages unchanged; the loop over layers
takes layer ``i``'s views with :func:`layer_params`. The decode cache is
preallocated (``(L, B, size, Kv, D)``) and written in place: a decode step
or a prefill returns a state that shares its cache tensors with the state
it was given. ``pos`` is a Python int.

MoE FFNs, MLA and the int8 KV cache come with the configs that use them
(ROADMAP.md Queue 1, LLM side).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.common import pspec
from repro_torch.common.device import DeviceLike
from repro_torch.common.pspec import torch_dtype
from repro_torch.models import attention, layers


def _check(cfg) -> None:
    if cfg.attn_kind != "gqa" or cfg.is_moe or cfg.kv_cache_dtype != "native":
        raise NotImplementedError(
            f"{cfg.arch_id}: only GQA attention, dense FFNs and a native KV "
            "cache are ported (MLA, MoE and the int8 cache: ROADMAP.md "
            "Queue 1, LLM side)")


def _layer_specs(cfg) -> Dict[str, Any]:
    return {"ln1": layers.norm_specs(cfg), "ln2": layers.norm_specs(cfg),
            "attn": attention.gqa_specs(cfg), "ffn": layers.ffn_specs(cfg)}


def param_specs(cfg) -> Dict[str, Any]:
    _check(cfg)
    return {
        "embed": layers.embed_specs(cfg),
        "layers": pspec.stack(_layer_specs(cfg), cfg.n_layers),
        "ln_f": layers.norm_specs(cfg),
    }


def layer_params(stacked, i: int):
    """Layer ``i``'s parameters: views into the ``(L, ...)`` stacks."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _layer_fwd(cfg, p, x: torch.Tensor, positions: torch.Tensor,
               window: int):
    """One layer over the whole sequence; returns (x, k, v) with k and v the
    layer's post-RoPE keys and values, which the prefill keeps."""
    h = layers.apply_norm(cfg, p["ln1"], x)
    q, k, v = attention._project_qkv(cfg, p["attn"], h, positions)
    o = attention.flash_attention(q, k, v, window=window)
    x = x + attention._out_proj(o, p["attn"]["wo"])
    h = layers.apply_norm(cfg, p["ln2"], x)
    return x + layers.apply_ffn(cfg, p["ffn"], h), k, v


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    return torch.arange(tokens.shape[1], device=tokens.device)[None, :]


def forward(cfg, params, tokens: torch.Tensor, *,
            window: Optional[int] = None):
    """tokens: (B, S) ints -> logits (B, S, padded_vocab) and the aux loss
    (0: no MoE router here)."""
    _check(cfg)
    w = cfg.sliding_window if window is None else window
    positions = _positions(tokens)
    x = layers.embed_tokens(cfg, params["embed"], tokens).to(
        torch_dtype(cfg.dtype))
    for i in range(cfg.n_layers):
        x, _, _ = _layer_fwd(cfg, layer_params(params["layers"], i), x,
                             positions, w)
    x = layers.apply_norm(cfg, params["ln_f"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return layers.logits(cfg, params["embed"], x), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg, batch: int, max_len: int, *, window: int = 0,
                      device: DeviceLike = None):
    """Stacked-over-layers KV cache (zeros) + position counter."""
    _check(cfg)
    one = attention.init_kv_cache(cfg, batch, max_len, window=window,
                                  device=device)
    cache = {k: torch.zeros((cfg.n_layers,) + tuple(a.shape), dtype=a.dtype,
                            device=a.device) for k, a in one.items()}
    return {"cache": cache, "pos": 0}


def _layer_cache(cache, i: int):
    return {k: a[i] for k, a in cache.items()}


def decode_step(cfg, params, state, tokens: torch.Tensor, *, window: int = 0):
    """One-token decode. tokens: (B,) ints. Returns (logits (B, V),
    new_state); the cache is updated in place."""
    _check(cfg)
    pos = state["pos"]
    x = layers.embed_tokens(cfg, params["embed"], tokens[:, None]).to(
        torch_dtype(cfg.dtype))
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = layers.apply_norm(cfg, lp["ln1"], x)
        h, _ = attention.gqa_decode(cfg, lp["attn"], h,
                                    _layer_cache(state["cache"], i), pos,
                                    window=window)
        x = x + h
        h = layers.apply_norm(cfg, lp["ln2"], x)
        x = x + layers.apply_ffn(cfg, lp["ffn"], h)
    x = layers.apply_norm(cfg, params["ln_f"], x)
    lg = layers.logits(cfg, params["embed"], x)[:, 0]
    return lg, {"cache": state["cache"], "pos": pos + 1}


def prefill(cfg, params, tokens: torch.Tensor, state, *, window: int = 0):
    """Batched prefill: one full forward that also fills the KV cache.

    tokens: (B, S_prompt). Returns (last-position logits (B, V), state with
    the cache's first S_prompt slots written and pos = S_prompt). Each layer
    runs its attention through :func:`attention.flash_attention` once (K11 on
    the card)."""
    _check(cfg)
    s = tokens.shape[1]
    positions = _positions(tokens)
    x = layers.embed_tokens(cfg, params["embed"], tokens).to(
        torch_dtype(cfg.dtype))
    for i in range(cfg.n_layers):
        lcache = _layer_cache(state["cache"], i)
        x, k, v = _layer_fwd(cfg, layer_params(params["layers"], i), x,
                             positions, window)
        lcache["k"][:, :s] = k.to(lcache["k"].dtype)
        lcache["v"][:, :s] = v.to(lcache["v"].dtype)
    x = layers.apply_norm(cfg, params["ln_f"], x[:, -1:])
    lg = layers.logits(cfg, params["embed"], x)[:, 0]
    return lg, {"cache": state["cache"], "pos": s}
