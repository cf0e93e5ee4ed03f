"""Decoder-only transformer (port of ``repro/models/transformer.py``): the
``dense``, ``vlm`` and ``moe`` families with GQA attention or deepseek-v2's
MLA, dense or MoE FFNs, and a KV cache in the activation dtype or in int8
(MLA: the latent cache).

Parameters stay stacked over layers, ``(L, ...)`` as in the JAX package, so
a weight tree crosses between the packages unchanged; every loop over layers
takes the stacks apart once with :func:`unstack` (``unbind``, whose
backward is one ``stack`` per leaf). The decode cache is
preallocated (``(L, B, size, Kv, D)``) and written in place: a decode step
or a prefill returns a state that shares its cache tensors with the state
it was given. ``pos`` is a Python int. As in the JAX package, MLA has no
batched prefill (:func:`prefill` raises): its forward stands in for one.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.common import pspec
from repro_torch.common.device import DeviceLike
from repro_torch.common.pspec import torch_dtype
from repro_torch.models import attention, layers, moe, remat


def _check(cfg) -> None:
    if cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.arch_id}: attn_kind {cfg.attn_kind!r} is not ported "
            "(ROADMAP.md Queue 1, LLM side)")


def _layer_specs(cfg) -> Dict[str, Any]:
    attn = (attention.mla_specs if cfg.attn_kind == "mla"
            else attention.gqa_specs)
    sp: Dict[str, Any] = {"ln1": layers.norm_specs(cfg),
                          "ln2": layers.norm_specs(cfg),
                          "attn": attn(cfg)}
    if cfg.is_moe:
        sp["moe"] = moe.moe_specs(cfg)
    else:
        sp["ffn"] = layers.ffn_specs(cfg)
    return sp


def param_specs(cfg) -> Dict[str, Any]:
    _check(cfg)
    return {
        "embed": layers.embed_specs(cfg),
        "layers": pspec.stack(_layer_specs(cfg), cfg.n_layers),
        "ln_f": layers.norm_specs(cfg),
    }


def unstack(stacked):
    """The ``(L, ...)`` stacks taken apart once: a list of L per-layer trees
    of views into them. Each leaf is one ``unbind(0)``, whose backward is
    one ``stack``; indexing each layer (``stacked[i]``) would have its
    backward write a zero-filled gradient of the whole stack per layer."""
    if isinstance(stacked, dict):
        parts = {k: unstack(v) for k, v in stacked.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(stacked.unbind(0))


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _ffn(cfg, p, h: torch.Tensor, aux: bool, rt=None):
    """The layer's FFN: ``(y, aux)``, aux None without a router or when
    ``aux`` is False (no kernel for a value that no caller reads). ``rt``
    reaches the MoE (a mesh's runtime, or None)."""
    if cfg.is_moe:
        return moe.moe_forward(cfg, p["moe"], h, rt, aux=aux)
    return layers.apply_ffn(cfg, p["ffn"], h), None


def _layer_fwd(cfg, p, x: torch.Tensor, positions: torch.Tensor,
               window: int, aux: bool, rt=None):
    """One layer over the whole sequence; returns (x, aux, k, v): aux as
    :func:`_ffn` gives it, k and v the layer's post-RoPE keys and values,
    which the prefill keeps (None for MLA, which has no prefill)."""
    h = layers.apply_norm(cfg, p["ln1"], x)
    if cfg.attn_kind == "mla":
        k = v = None
        x = x + attention.mla_forward(cfg, p["attn"], h, window=window)
    else:
        q, k, v = attention._project_qkv(cfg, p["attn"], h, positions)
        o = attention.flash_attention(q, k, v, window=window)
        x = x + attention._out_proj(o, p["attn"]["wo"])
    h, a = _ffn(cfg, p, layers.apply_norm(cfg, p["ln2"], x), aux, rt)
    return x + h, a, k, v


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    return torch.arange(tokens.shape[1], device=tokens.device)[None, :]


def forward(cfg, params, tokens: torch.Tensor, rt=None, *,
            window: Optional[int] = None, last_only: bool = False):
    """tokens: (B, S) ints -> logits (B, S, padded_vocab) and the routers'
    aux loss summed over layers (0 without MoE). Under a mesh (``rt``,
    ``common/runtime.py``) ``tokens`` are this rank's rows and the MoE
    layers may run expert-parallel. ``last_only`` cuts the final hidden
    state to the last position before the unembedding: logits (B, 1,
    padded_vocab), as the prefill step needs (no (B, S, V) logits). Each
    layer is one region of ``models/remat.py`` (``cfg.remat``), which
    returns only ``(x, aux)``: the layer's k and v are not held."""
    _check(cfg)
    w = cfg.sliding_window if window is None else window
    positions = _positions(tokens)
    x = layers.embed_tokens(cfg, params["embed"], tokens).to(
        torch_dtype(cfg.dtype))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, aux, lp):
        if rt is not None:
            x = rt.seq_shard(x, cfg)
        x, a, _, _ = _layer_fwd(cfg, lp, x, positions, w, aux=True, rt=rt)
        return x, (aux if a is None else aux + a)

    layer = remat.checkpointed(cfg, body)
    for lp in unstack(params["layers"]):
        x, aux = layer(x, aux, lp)
    if last_only:
        x = x[:, -1:]
    x = layers.apply_norm(cfg, params["ln_f"], x)
    return layers.logits(cfg, params["embed"], x), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg, batch: int, max_len: int, *, window: int = 0,
                      device: DeviceLike = None):
    """Stacked-over-layers KV cache (zeros) + position counter; int8 codes
    and scales when ``cfg.kv_cache_dtype == "int8"``; MLA's latent cache
    (no window) whatever the cache dtype, as in the JAX package."""
    _check(cfg)
    if cfg.attn_kind == "mla":
        one = attention.init_mla_cache(cfg, batch, max_len, device=device)
    else:
        init = (attention.init_kv_cache_int8 if cfg.kv_cache_dtype == "int8"
                else attention.init_kv_cache)
        one = init(cfg, batch, max_len, window=window, device=device)
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
    decode = (attention.gqa_decode_int8 if cfg.kv_cache_dtype == "int8"
              else attention.gqa_decode)
    x = layers.embed_tokens(cfg, params["embed"], tokens[:, None]).to(
        torch_dtype(cfg.dtype))
    for i, lp in enumerate(unstack(params["layers"])):
        h = layers.apply_norm(cfg, lp["ln1"], x)
        lcache = _layer_cache(state["cache"], i)
        if cfg.attn_kind == "mla":
            h, _ = attention.mla_decode(cfg, lp["attn"], h, lcache, pos)
        else:
            h, _ = decode(cfg, lp["attn"], h, lcache, pos, window=window)
        x = x + h
        h, _ = _ffn(cfg, lp, layers.apply_norm(cfg, lp["ln2"], x), aux=False)
        x = x + h
    x = layers.apply_norm(cfg, params["ln_f"], x)
    lg = layers.logits(cfg, params["embed"], x)[:, 0]
    return lg, {"cache": state["cache"], "pos": pos + 1}


def prefill(cfg, params, tokens: torch.Tensor, state, *, window: int = 0):
    """Batched prefill: one full forward that also fills the KV cache.

    tokens: (B, S_prompt). Returns (last-position logits (B, V), state with
    the cache's first S_prompt slots written and pos = S_prompt). Each layer
    runs its attention through :func:`attention.flash_attention` once (K11 on
    the card). MLA and the int8 cache raise, as in the JAX package."""
    _check(cfg)
    if cfg.attn_kind == "mla" or cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("prefill supports native GQA caches only")
    s = tokens.shape[1]
    positions = _positions(tokens)
    x = layers.embed_tokens(cfg, params["embed"], tokens).to(
        torch_dtype(cfg.dtype))
    for i, lp in enumerate(unstack(params["layers"])):
        lcache = _layer_cache(state["cache"], i)
        x, _, k, v = _layer_fwd(cfg, lp, x, positions, window, aux=False)
        lcache["k"][:, :s] = k.to(lcache["k"].dtype)
        lcache["v"][:, :s] = v.to(lcache["v"].dtype)
    x = layers.apply_norm(cfg, params["ln_f"], x[:, -1:])
    lg = layers.logits(cfg, params["embed"], x)[:, 0]
    return lg, {"cache": state["cache"], "pos": s}
