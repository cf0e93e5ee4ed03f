"""Zamba2-style hybrid (port of ``repro/models/hybrid.py``): Mamba2 backbone
+ a single weight-shared attention block applied every ``attn_period``
positions, with per-occurrence LoRA on the concat projection.
[arXiv:2411.15242]

Layer plan for ``n_layers`` total positions and period P:
  ``n_super = n_layers // P`` super-blocks of (P-1 mamba blocks + shared attn),
  followed by ``n_layers % P`` trailing mamba blocks.
The shared block consumes concat(hidden, original_embedding) -> d via
``w_concat`` (LoRA-adapted per occurrence), runs attn+FFN, and its output is
projected (``w_proj``) and added residually — the Zamba wiring.

The mamba blocks are :mod:`ssm`'s. The shared block's attention is
:func:`attention.gqa_forward` in the forward (kernel K11 on the card, once
per super-block; zamba2-7b's heads are 112 wide) and
:func:`attention.gqa_decode`'s plain readout in decode. Parameters stay
stacked as in the JAX package: ``mamba`` (n_super, P-1, ...), ``lora``
(n_super, ...), ``tail`` (n_tail, ...); each loop over them takes them
apart once with ``transformer.unstack``. The decode state is preallocated and
written in place: mamba states (n_super, P-1, B, ...), one KV cache per
super-block (n_super, B, size, Kv, D), the tail's states (n_tail, B, ...);
``pos`` is a Python int. Each super-block of the forward is one region
of ``models/remat.py`` (``cfg.remat``); the tail blocks are not, as in the
JAX package. The JAX ``forward``'s ``rt`` is not ported: no caller of the
port passes it (``last_only`` is, for the sharded prefill step).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.common import pspec
from repro_torch.common.device import DeviceLike
from repro_torch.common.pspec import ParamSpec, torch_dtype
from repro_torch.models import attention, layers, remat, ssm
from repro_torch.models.transformer import unstack


def _n_super(cfg) -> int:
    return cfg.n_layers // cfg.attn_period


def _n_tail(cfg) -> int:
    return cfg.n_layers % cfg.attn_period


def _mamba_block_specs(cfg) -> Dict[str, Any]:
    return {"ln": layers.norm_specs(cfg), "mixer": ssm.mamba_specs(cfg)}


def _shared_specs(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    return {
        "w_concat": ParamSpec((2 * d, d), ("mlp", "embed"), "scaled", dt),
        "ln1": layers.norm_specs(cfg),
        "attn": attention.gqa_specs(cfg),
        "ln2": layers.norm_specs(cfg),
        "ffn": layers.ffn_specs(cfg),
        "w_proj": ParamSpec((d, d), ("embed", "mlp"), "scaled", dt),
    }


def _lora_specs(cfg) -> Dict[str, ParamSpec]:
    d, r = cfg.d_model, cfg.lora_rank
    dt = torch_dtype(cfg.param_dtype)
    return {
        "a": ParamSpec((2 * d, r), ("mlp", "null"), "scaled", dt),
        "b": ParamSpec((r, d), ("null", "embed"), "zeros", dt),
    }


def param_specs(cfg) -> Dict[str, Any]:
    if cfg.attn_period < 2 or cfg.lora_rank <= 0:
        raise ValueError(f"{cfg.arch_id}: hybrid requires attn_period >= 2 "
                         f"and lora_rank > 0, got {cfg.attn_period}, "
                         f"{cfg.lora_rank}")
    ns, nt = _n_super(cfg), _n_tail(cfg)
    sp = {
        "embed": layers.embed_specs(cfg),
        # the outer "layers" axis: pspec.materialize draws one super-block's
        # P-1 blocks at a time
        "mamba": pspec.stack(
            pspec.stack(_mamba_block_specs(cfg), cfg.attn_period - 1,
                        "stack"), ns),
        "shared": _shared_specs(cfg),
        "ln_f": layers.norm_specs(cfg),
        "lora": pspec.stack(_lora_specs(cfg), ns),
    }
    if nt:
        sp["tail"] = pspec.stack(_mamba_block_specs(cfg), nt)
    return sp


def _tail(cfg, params):
    """The trailing mamba blocks' parameters, one tree each (none when
    ``n_layers`` is a multiple of the period)."""
    return unstack(params["tail"]) if _n_tail(cfg) else []


def _mamba_block(cfg, lp, x: torch.Tensor) -> torch.Tensor:
    return x + ssm.mamba_forward(cfg, lp["mixer"],
                                 layers.apply_norm(cfg, lp["ln"], x))


def _shared_block(cfg, sp, lora, x: torch.Tensor, x0: torch.Tensor,
                  attn_fn) -> torch.Tensor:
    """concat(x, x0) through ``w_concat`` plus the occurrence's LoRA, then
    ``attn_fn(sp, normed h)`` and the FFN, each residual, then ``w_proj``
    added to x."""
    xin = torch.cat([x, x0], dim=-1)
    h = remat.matmul(xin, sp["w_concat"])
    # einsum("bsd,dr,rf->bsf") in the order the JAX package's einsum
    # contracts it: two no-batch products, each kept under remat
    h = h + remat.matmul(remat.matmul(xin, lora["a"]), lora["b"])
    h = h + attn_fn(sp, layers.apply_norm(cfg, sp["ln1"], h))
    h = h + layers.apply_ffn(cfg, sp["ffn"],
                             layers.apply_norm(cfg, sp["ln2"], h))
    return x + remat.matmul(h, sp["w_proj"])


def forward(cfg, params, tokens: torch.Tensor, *,
            window: Optional[int] = None, last_only: bool = False):
    """tokens: (B, S) ints -> logits (B, S, padded_vocab) and a zero aux
    loss."""
    w = cfg.sliding_window if window is None else window
    x0 = layers.embed_tokens(cfg, params["embed"], tokens).to(
        torch_dtype(cfg.dtype))
    shared = params["shared"]

    def attn_fn(sp, h):
        return attention.gqa_forward(cfg, sp["attn"], h, window=w)

    def super_body(x, x0, shared, blocks, lora):
        for lp in unstack(blocks):
            x = _mamba_block(cfg, lp, x)
        return _shared_block(cfg, shared, lora, x, x0, attn_fn)

    super_block = remat.checkpointed(cfg, super_body)
    x = x0
    for blocks, lora in zip(unstack(params["mamba"]),
                            unstack(params["lora"])):
        x = super_block(x, x0, shared, blocks, lora)
    for lp in _tail(cfg, params):
        x = _mamba_block(cfg, lp, x)
    if last_only:
        x = x[:, -1:]
    x = layers.apply_norm(cfg, params["ln_f"], x)
    return (layers.logits(cfg, params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg, batch: int, max_len: int, *, window: int = 0,
                      device: DeviceLike = None):
    """Zeros: the mamba states (n_super, P-1, ...), the shared block's KV
    cache per super-block (n_super, ...), the tail's states (n_tail, ...),
    and the position counter."""
    ns, nt = _n_super(cfg), _n_tail(cfg)
    m_one = ssm.init_mamba_state(cfg, batch, device)
    kv_one = attention.init_kv_cache(cfg, batch, max_len, window=window,
                                     device=device)
    state = {"mamba": ssm.stacked_state(m_one, ns, cfg.attn_period - 1),
             "attn": ssm.stacked_state(kv_one, ns), "pos": 0}
    if nt:
        state["tail"] = ssm.stacked_state(m_one, nt)
    return state


def _mamba_step(cfg, lp, x: torch.Tensor, st) -> torch.Tensor:
    h = layers.apply_norm(cfg, lp["ln"], x)
    h, _ = ssm.mamba_decode(cfg, lp["mixer"], h, st)
    return x + h


def decode_step(cfg, params, state, tokens: torch.Tensor, *, window: int = 0):
    """One-token decode. tokens: (B,) ints. Returns (logits (B, V),
    new_state); the states and caches are updated in place."""
    pos = state["pos"]
    x0 = layers.embed_tokens(cfg, params["embed"], tokens[:, None]).to(
        torch_dtype(cfg.dtype))
    shared = params["shared"]
    x = x0
    for s, (blocks, lora) in enumerate(zip(unstack(params["mamba"]),
                                           unstack(params["lora"]))):
        for j, lp in enumerate(unstack(blocks)):
            x = _mamba_step(cfg, lp, x,
                            {k: a[s, j] for k, a in state["mamba"].items()})
        cache = {k: a[s] for k, a in state["attn"].items()}

        def attn_fn(sp, h, cache=cache):
            out, _ = attention.gqa_decode(cfg, sp["attn"], h, cache, pos,
                                          window=window)
            return out

        x = _shared_block(cfg, shared, lora, x, x0, attn_fn)
    for t, lp in enumerate(_tail(cfg, params)):
        x = _mamba_step(cfg, lp, x,
                        {k: a[t] for k, a in state["tail"].items()})
    x = layers.apply_norm(cfg, params["ln_f"], x)
    lg = layers.logits(cfg, params["embed"], x)[:, 0]
    return lg, dict(state, pos=pos + 1)
