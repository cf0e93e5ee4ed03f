"""Mixture-of-Experts FFN with two execution paths (port of
``repro/models/moe.py``).

* ``moe_dense`` computes every expert on every token and combines the
  experts' outputs with the router's one-hot ``(T, E)`` weights: the JAX
  package's exact path, and the one it takes without a device mesh.
* ``moe_expert_parallel``, GShard-style explicit dispatch on a mesh
  (``common/runtime.py``): tokens split over every mesh axis, experts over
  ``model``; two ``all_to_all`` collectives over the model axis move token
  copies to and from the experts' owners with a fixed per-(device, expert)
  capacity, and the copies past it are dropped. The JAX package runs it
  under ``shard_map``; the port runs the same body on every rank.

Router: f32 logits, softmax, top-k, renormalized with a 1e-9 floor; the
Switch-style load-balance loss is ``aux = E * sum_e f_e * P_e``, its two
means taken over every rank's tokens under a mesh. Shared experts
(deepseek-v2's ``n_shared_experts``) are one FFN of ``n_shared_experts *
d_ff_expert`` that every token runs, added after the routed combine.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.common import runtime
from repro_torch.common.pspec import ParamSpec, torch_dtype
from repro_torch.models import layers, remat

EXPERT_LEAVES = ("wi", "wg", "wo")  # the leaves split over the model axis


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
    logits = remat.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    return w, ids, probs


def _global_mean(x: torch.Tensor, rt) -> torch.Tensor:
    """``x`` averaged over every rank of ``rt``'s mesh (``jax.lax.pmean``
    over all axes); ``x`` itself without a mesh."""
    if rt is None or rt.mesh is None:
        return x
    return runtime.psum(x, rt, rt.all_axes) / rt.n_devices


def _aux_loss(cfg, probs: torch.Tensor, ids: torch.Tensor,
              rt=None) -> torch.Tensor:
    """Switch load-balance loss: ``E * sum_e f_e * P_e`` with ``f`` the
    share of routed copies per expert and ``P`` the mean probability, each
    a mean over every rank's tokens under a mesh (each rank routes as many
    tokens), as the JAX package's global arrays give."""
    counts = _one_hot(ids.reshape(-1), cfg.n_experts).sum(dim=0)
    f = _global_mean(counts / max(ids.numel(), 1), rt)
    return cfg.n_experts * torch.sum(f * _global_mean(probs.mean(dim=0), rt))


def _one_hot(ids: torch.Tensor, e: int) -> torch.Tensor:
    """ids (...) -> f32 one-hot (..., e), by comparison, which reads nothing
    back to the host (on the card ``torch.bincount`` reads the largest id
    back: a sync in every MoE layer of every decode step)."""
    return (ids[..., None] == torch.arange(e, device=ids.device)).float()


# ---------------------------------------------------------------------------
# Dense (exact) path
# ---------------------------------------------------------------------------

def moe_dense(cfg, p, x: torch.Tensor, *, aux: bool = True, rt=None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (..., d) -> (y of x's shape, aux). Every expert runs on every
    token; the router's one-hot weights combine them. ``aux=False`` gives
    None for aux: decode and prefill drop it, and computing it would launch
    its kernels in every MoE layer of every step. Under a mesh (``rt``) the
    aux loss's means run over every rank."""
    xt = x.reshape(-1, x.shape[-1])  # (T, d)
    w, ids, probs = _router(cfg, p["router"], xt)
    y_all = _expert_ffn(cfg, p, xt)  # (E, T, d)
    combine = torch.einsum("tk,tke->te", w,
                           _one_hot(ids, cfg.n_experts))  # (T, E)
    y = torch.einsum("te,etd->td", combine.to(y_all.dtype), y_all)
    return y.reshape(x.shape), (_aux_loss(cfg, probs, ids, rt) if aux
                                else None)


# ---------------------------------------------------------------------------
# Expert-parallel path (two all_to_all over the model axis)
# ---------------------------------------------------------------------------

def _positions_within_expert(flat_e: torch.Tensor,
                             n_experts: int) -> torch.Tensor:
    """Rank of each copy among same-expert copies, in copy order (a stable
    sort, as ``jnp.argsort`` is; O(N log N))."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(n, device=flat_e.device)
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=flat_e.device),
                           sorted_e[1:] != sorted_e[:-1]])
    start_idx = torch.cummax(torch.where(seg_start, idx, 0), dim=0).values
    rank_sorted = (idx - start_idx).to(torch.int32)
    # ``order`` is a permutation: each position is written once
    return torch.zeros(n, dtype=torch.int32,
                       device=flat_e.device).index_put((order,), rank_sorted)


def _dispatch_compute_combine(cfg, p, x_l: torch.Tensor, rt, capacity: int):
    """One rank's body. x_l: (T_l, d) the rank's tokens; ``p`` holds the
    rank's experts. Returns y (T_l, d) and the router's ids and
    probabilities, from which the caller takes the aux loss."""
    t_l, d = x_l.shape
    e, k = cfg.n_experts, cfg.top_k
    m = rt.axis_size((rt.model_axis,))
    e_l, c = e // m, capacity

    w, ids, probs = _router(cfg, p["router"], x_l)
    flat_e = ids.reshape(-1)  # (N,)
    pos = _positions_within_expert(flat_e, e).long()
    keep = pos < c
    dest = flat_e // e_l
    le = flat_e % e_l
    tok = torch.arange(flat_e.shape[0], device=x_l.device) // k
    safe_pos = torch.where(keep, pos, c - 1)

    # the kept copies into their unique (dest, le, pos) slots, one write
    # each; the dropped ones into a spare row past the buffer, cut off
    slot = torch.where(keep, (dest * e_l + le) * c + pos, m * e_l * c)
    send = x_l.new_zeros((m * e_l * c + 1, d)).index_put((slot,), x_l[tok])
    recv = runtime.all_to_all(send[:-1].view(m, e_l, c, d), rt,
                              rt.model_axis)
    h = recv.transpose(0, 1).reshape(e_l, m * c, d)
    y = _expert_ffn(cfg, p, h)
    y = y.reshape(e_l, m, c, d).transpose(0, 1)
    back = runtime.all_to_all(y, rt, rt.model_axis)

    y_copies = back[dest, le, safe_pos] * keep[:, None].to(back.dtype)
    y_tok = (y_copies.reshape(t_l, k, d)
             * w[..., None].to(back.dtype)).sum(dim=1)
    return y_tok.to(x_l.dtype), ids, probs


def _capacity(cfg, t_l: int) -> int:
    """Slots per (device, expert): the JAX package's rule, rounded up to a
    multiple of 4 and capped at every copy."""
    capacity = max(int(t_l * cfg.top_k / cfg.n_experts * cfg.capacity_factor),
                   1)
    return min(capacity + (-capacity) % 4, t_l * cfg.top_k)


def moe_expert_parallel(cfg, p, x: torch.Tensor, rt, *, aux: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, d), this rank's rows. The tokens flatten and split over
    every mesh axis as ``P(all axes)`` gives: the rank's rows are replicated
    along the axes in ``token_axes`` below, and the rank takes its chunk of
    them by its index there, so device (d, m) owns chunk d·M + m of the
    global tokens. The experts' leaves may be whole (E experts) or the
    rank's slice over the model axis; the router is whole."""
    if rt is None or rt.mesh is None:
        raise ValueError("moe_impl='expert_parallel' needs a device mesh: "
                         "pass rt, a Runtime with one (launch.mesh)")
    token_axes = ((rt.model_axis,) if rt.batch_split else rt.all_axes)
    n_rep = rt.axis_size(token_axes)
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    if xt.shape[0] % n_rep:
        raise ValueError(f"{xt.shape[0]} tokens do not split over "
                         f"{n_rep} ranks along {token_axes}")
    t_l = xt.shape[0] // n_rep
    i = rt.axis_index(token_axes)
    e_l = cfg.n_experts // rt.axis_size((rt.model_axis,))
    first = rt.axis_index((rt.model_axis,)) * e_l
    pl = {"router": p["router"]}
    for name in EXPERT_LEAVES:
        if name in p:
            leaf = p[name]
            pl[name] = leaf if leaf.shape[0] == e_l else leaf.narrow(
                0, first, e_l)
    y_l, ids, probs = _dispatch_compute_combine(
        cfg, pl, xt[i * t_l:(i + 1) * t_l], rt, _capacity(cfg, t_l))
    y = runtime.all_gather(y_l, rt, token_axes).reshape(x.shape)
    # the load-balance factors' means over every rank (each holds t_l
    # tokens), as the JAX package's pmean over all axes
    return y, (_aux_loss(cfg, probs, ids, rt) if aux else None)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def resolve_impl(cfg, tokens: int, rt=None) -> str:
    """``cfg.moe_impl`` with ``"auto"`` resolved as the JAX package does:
    expert-parallel on a mesh whose device count divides the batch's
    ``tokens`` (all ranks' together) and whose model axis divides the
    experts, else dense."""
    if cfg.moe_impl != "auto":
        return cfg.moe_impl
    ok = (rt is not None and rt.mesh is not None
          and tokens % rt.n_devices == 0
          and cfg.n_experts % rt.axis_size((rt.model_axis,)) == 0)
    return "expert_parallel" if ok else "dense"


def moe_forward(cfg, p, x: torch.Tensor, rt=None, *, aux: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MoE FFN by :func:`resolve_impl`, then the shared experts' FFN
    added. ``x`` is this rank's rows under a mesh. Returns ``(y, aux)``,
    aux None when ``aux`` is False."""
    tokens = x.numel() // x.shape[-1]
    if rt is not None and rt.mesh is not None and rt.batch_split:
        tokens *= rt.axis_size(rt.data_axes)
    if resolve_impl(cfg, tokens, rt) == "expert_parallel":
        y, a = moe_expert_parallel(cfg, p, x, rt, aux=aux)
    else:
        y, a = moe_dense(cfg, p, x, aux=aux, rt=rt)
    if cfg.n_shared_experts:
        y = y + layers.apply_ffn(cfg, p["shared"], x)
    return y, a
