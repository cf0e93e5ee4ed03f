"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``'s dense path).

``moe_dense`` computes every expert on every token and combines the
experts' outputs with the router's one-hot ``(T, E)`` weights: the JAX
package's exact path, and the one it takes whenever there is no device
mesh. Router: f32 logits, softmax, top-k, renormalized with a 1e-9 floor;
the Switch-style load-balance loss is ``aux = E * sum_e f_e * P_e``.
Shared experts (deepseek-v2's ``n_shared_experts``) are one FFN of
``n_shared_experts * d_ff_expert`` that every token runs, added after the
routed combine.

The expert-parallel path (``shard_map`` and two ``all_to_all``) is
distribution tooling and raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.pspec import ParamSpec, torch_dtype
from repro_torch.models import layers


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    f = cfg.d_ff_expert or cfg.d_ff
    e = cfg.n_experts
    dt = torch_dtype(cfg.param_dtype)
    sp = {
        # the router is f32 whatever the weights' dtype
        "router": ParamSpec((d, e), ("embed", "experts"), "scaled",
                            torch.float32),
        "wi": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"),
                        "scaled", dt, fan_in=d),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed"),
                        "scaled", dt, fan_in=f),
    }
    if cfg.act == "swiglu":
        sp["wg"] = ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"),
                             "scaled", dt, fan_in=d)
    if cfg.n_shared_experts:
        sp["shared"] = layers.ffn_specs(cfg, d_ff=cfg.n_shared_experts * f)
    return sp


def _expert_ffn(cfg, p, h: torch.Tensor) -> torch.Tensor:
    """h: (T, d) or (E, T, d) -> (E, T, d) through every expert's FFN."""
    if cfg.act != "swiglu":
        raise NotImplementedError(f"expert act {cfg.act!r} is not ported yet "
                                  "(ROADMAP.md Queue 1, LLM side)")
    up = torch.matmul(h, p["wi"])
    g = torch.matmul(h, p["wg"])
    up = up * torch.nn.functional.silu(g.float()).to(up.dtype)
    return torch.matmul(up, p["wo"])


def _router(cfg, router_w: torch.Tensor, x: torch.Tensor):
    """x: (T, d) -> weights (T, k), expert ids (T, k), probabilities (T, E)."""
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    return w, ids, probs


def _aux_loss(cfg, probs: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss: ``E * sum_e f_e * P_e`` with ``f`` the
    share of routed copies per expert and ``P`` the mean probability."""
    counts = _one_hot(ids.reshape(-1), cfg.n_experts).sum(dim=0)
    f = counts / max(ids.numel(), 1)
    return cfg.n_experts * torch.sum(f * probs.mean(dim=0))


def _one_hot(ids: torch.Tensor, e: int) -> torch.Tensor:
    """ids (...) -> f32 one-hot (..., e), by comparison, which reads nothing
    back to the host (on the card ``torch.bincount`` reads the largest id
    back: a sync in every MoE layer of every decode step)."""
    return (ids[..., None] == torch.arange(e, device=ids.device)).float()


def moe_dense(cfg, p, x: torch.Tensor, *, aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (..., d) -> (y of x's shape, aux). Every expert runs on every
    token; the router's one-hot weights combine them. ``aux=False`` gives
    None for aux: decode and prefill drop it, and computing it would launch
    its kernels in every MoE layer of every step."""
    xt = x.reshape(-1, x.shape[-1])  # (T, d)
    w, ids, probs = _router(cfg, p["router"], xt)
    y_all = _expert_ffn(cfg, p, xt)  # (E, T, d)
    combine = torch.einsum("tk,tke->te", w,
                           _one_hot(ids, cfg.n_experts))  # (T, E)
    y = torch.einsum("te,etd->td", combine.to(y_all.dtype), y_all)
    return y.reshape(x.shape), (_aux_loss(cfg, probs, ids) if aux else None)


def moe_forward(cfg, p, x: torch.Tensor, *, aux: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MoE FFN: ``moe_dense`` for ``"dense"`` and for ``"auto"``, which
    resolves to it as the JAX package does without a mesh, then the shared
    experts' FFN added. Returns ``(y, aux)``, aux None when ``aux`` is
    False."""
    if cfg.moe_impl == "expert_parallel":
        raise NotImplementedError(
            "moe_impl='expert_parallel' (shard_map + all_to_all) is not "
            "ported yet (ROADMAP.md Queue 1 item 9, distribution tooling)")
    y, a = moe_dense(cfg, p, x, aux=aux)
    if cfg.n_shared_experts:
        y = y + layers.apply_ffn(cfg, p["shared"], x)
    return y, a
