"""Mamba2 (state-space duality / SSD) blocks (port of
``repro/models/ssm.py``). [arXiv:2405.21060]

Training / prefill use the chunked SSD algorithm: quadratic attention-like
computation inside fixed-size chunks plus a linear recurrence over chunk
states. Decode is the O(1)-state recurrence h <- h*exp(dt*A) + dt*(B (x) x).

Shapes: x (B,S,d); inner width d_in = expand*d; H = d_in/headdim SSD heads;
G groups of (B,C) projections of state size N; depthwise causal conv of width
d_conv over the [x, B, C] channels.

The JAX package computes the scan in jnp (no Pallas kernel), so stock torch
is its port. The casts and the orders of the sums are the JAX package's:
the conv adds its K shifted products in ``sum``'s order in the input's
dtype, then the bias, and takes SiLU in f32; the scan runs in f32; softplus
is ``logaddexp(x, 0)`` (:func:`softplus`), not torch's thresholded one.

Parameters stay stacked over layers (``(L, ...)``; each loop over layers
takes them apart once with ``transformer.unstack``); the decode state is
preallocated (``conv`` (L, B, d_conv-1, conv_dim) in ``cfg.dtype``, ``ssm``
(L, B, H, N, P) in f32) and written in place; ``pos`` is a Python int.
Each block of the forward is one region of ``models/remat.py``
(``cfg.remat``). The JAX ``forward``'s ``rt`` is not ported: no caller of
the port passes it (``last_only`` is, for the sharded prefill step).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.common import pspec
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.pspec import ParamSpec, torch_dtype
from repro_torch.models import layers, remat
from repro_torch.models.transformer import unstack

State = Dict[str, torch.Tensor]


def mamba_specs(cfg) -> Dict[str, ParamSpec]:
    """Input projections SPLIT (z / x / BC / dt), as in the JAX package."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads
    conv_dim = di + 2 * g * n
    dt = torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    return {
        "w_z": ParamSpec((d, di), ("embed", "ssm_inner"), "scaled", dt),
        "w_x": ParamSpec((d, di), ("embed", "ssm_inner"), "scaled", dt),
        "w_bc": ParamSpec((d, 2 * g * n), ("embed", "ssm_inner"), "scaled",
                          dt),
        "w_dt": ParamSpec((d, h), ("embed", "null"), "scaled", dt),
        "conv_w": ParamSpec((cfg.d_conv, conv_dim), ("conv", "ssm_inner"),
                            "uniform_conv", dt),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), "zeros", dt),
        "a_log": ParamSpec((h,), ("ssm_heads",), "ones", f32),
        "d_skip": ParamSpec((h,), ("ssm_heads",), "ones", f32),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), "zeros", f32),
        "norm": ParamSpec((di,), ("ssm_inner",), "ones", dt),
        "w_out": ParamSpec((di, d), ("ssm_inner", "embed"), "scaled", dt),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    (``torch.nn.functional.softplus`` returns ``x`` itself above 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _project_in(cfg, p, x: torch.Tensor):
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    z = remat.matmul(x, p["w_z"])
    xc = remat.matmul(x, p["w_x"])
    bc = remat.matmul(x, p["w_bc"])
    bm, cm = bc[..., : g * n], bc[..., g * n:]
    dt = remat.matmul(x, p["w_dt"])
    return z, xc, bm, cm, dt


def _causal_conv(conv_w: torch.Tensor, conv_b: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. u: (B, S, C); conv_w: (K, C). The K shifted
    products are added first to last in u's dtype (``sum``'s 0 + t0 + t1
    + ...), then the bias; SiLU in f32, cast back."""
    k, s = conv_w.shape[0], u.shape[1]
    pad = torch.nn.functional.pad(u, (0, 0, k - 1, 0))
    out = pad[:, 0:s, :] * conv_w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s, :] * conv_w[i]
    out = out + conv_b
    return torch.nn.functional.silu(out.float()).to(u.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bm: torch.Tensor, cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """SSD scan. x:(B,S,H,P) dt:(B,S,H) a:(H,) bm/cm:(B,S,G,N) -> (B,S,H,P)
    in x's dtype; everything inside in f32."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    rep = h // g
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        bm = torch.nn.functional.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = torch.nn.functional.pad(cm, (0, 0, 0, 0, 0, pad))
    sp = x.shape[1]
    nc = sp // q

    f32 = torch.float32
    xd = (x.to(f32) * dt[..., None].to(f32)).reshape(b, nc, q, h, p)
    da = (dt.to(f32) * a.to(f32)).reshape(b, nc, q, h)
    bh = bm.to(f32).repeat_interleave(rep, dim=2).reshape(b, nc, q, h, n)
    ch = cm.to(f32).repeat_interleave(rep, dim=2).reshape(b, nc, q, h, n)

    # (b, nc, h, q)
    cum = torch.cumsum(da, dim=2).permute(0, 1, 3, 2)
    xd_t = xd.permute(0, 1, 3, 2, 4)  # (b,nc,h,q,p)
    b_t = bh.permute(0, 1, 3, 2, 4)  # (b,nc,h,q,n)
    c_t = ch.permute(0, 1, 3, 2, 4)

    # intra-chunk (diagonal blocks). exp overflows to inf above the
    # diagonal: masked_fill drops those entries, as JAX's where does (a
    # product with a 0/1 mask would make inf * 0 = NaN)
    decay = torch.exp(cum[..., :, None] - cum[..., None, :])  # (b,nc,h,q,q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    lmat = decay.masked_fill(~tri, 0.0)
    scores = torch.einsum("bchqn,bchkn->bchqk", c_t, b_t)
    y_diag = torch.einsum("bchqk,bchkp->bchqp", scores * lmat, xd_t)

    # chunk states and the inter-chunk recurrence (lax.scan over chunks,
    # emitting each chunk's incoming state)
    decay_end = torch.exp(cum[..., -1:] - cum)  # (b,nc,h,q)
    states = torch.einsum("bchq,bchqn,bchqp->bchnp", decay_end, b_t, xd_t)
    chunk_decay = torch.exp(cum[..., -1])  # (b,nc,h)
    carry = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b,nc,h,n,p)

    decay_out = torch.exp(cum)  # (b,nc,h,q)
    y_off = torch.einsum("bchqn,bchnp,bchq->bchqp", c_t, prev_states,
                         decay_out)

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, sp, h, p)
    return y[:, :s].to(x.dtype)


def _gate_norm_out(p, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``rms_norm(y * silu(z))`` (the gate in f32, cast to y's dtype), then
    the out projection."""
    y = layers.rms_norm(y * torch.nn.functional.silu(z.float()).to(y.dtype),
                        p["norm"])
    return remat.matmul(y, p["w_out"])


def mamba_forward(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence mamba2 mixer. x: (B, S, d) -> (B, S, d)."""
    di, g, n, h = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads
    hd = cfg.ssm_headdim
    bsz, s = x.shape[:2]
    z, xc, bm, cm, dt = _project_in(cfg, p, x)
    conv_in = torch.cat([xc, bm, cm], dim=-1)
    conv_out = _causal_conv(p["conv_w"], p["conv_b"], conv_in)
    xc = conv_out[..., :di]
    bm = conv_out[..., di:di + g * n].reshape(bsz, s, g, n)
    cm = conv_out[..., di + g * n:].reshape(bsz, s, g, n)

    dt = softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    xh = xc.reshape(bsz, s, h, hd)
    y = ssd_chunked(xh, dt, a, bm, cm, cfg.ssm_chunk)
    y = y + p["d_skip"].to(y.dtype)[None, None, :, None] * xh
    return _gate_norm_out(p, y.reshape(bsz, s, di), z)


# ---------------------------------------------------------------------------
# Decode (recurrent)
# ---------------------------------------------------------------------------

def init_mamba_state(cfg, batch: int, device: DeviceLike = None) -> State:
    """One block's state: ``conv`` (B, d_conv-1, conv_dim) in ``cfg.dtype``
    and ``ssm`` (B, H, N, P) in f32, zeros."""
    di, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di + 2 * g * n),
                            dtype=torch_dtype(cfg.dtype), device=dev),
        "ssm": torch.zeros((batch, cfg.n_ssm_heads, n, cfg.ssm_headdim),
                           dtype=torch.float32, device=dev),
    }


def mamba_decode(cfg, p, x: torch.Tensor, state: State):
    """One-token step. x: (B, 1, d) -> ((B, 1, d), state); ``state``'s conv
    window and SSM state are updated in place."""
    di, g, n, h = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads
    hd = cfg.ssm_headdim
    bsz = x.shape[0]
    z, xc, bm, cm, dt = _project_in(cfg, p, x)
    u = torch.cat([xc, bm, cm], dim=-1)  # (B,1,conv_dim)
    window = torch.cat([state["conv"], u], dim=1)  # (B,d_conv,cdim)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = torch.nn.functional.silu(conv_out.float()).to(x.dtype)[:, None]
    state["conv"].copy_(window[:, 1:])

    xc = conv_out[..., :di]
    bm = conv_out[..., di:di + g * n].reshape(bsz, 1, g, n)
    cm = conv_out[..., di + g * n:].reshape(bsz, 1, g, n)

    dtv = softplus(dt.float() + p["dt_bias"])[:, 0]  # (B,H)
    a = -torch.exp(p["a_log"].float())
    xh = xc.reshape(bsz, h, hd).float()
    rep = h // g
    bh = bm[:, 0].float().repeat_interleave(rep, dim=1)  # (B,H,N)
    chh = cm[:, 0].float().repeat_interleave(rep, dim=1)

    decay = torch.exp(dtv * a)  # (B,H)
    ssm = state["ssm"]
    ssm.mul_(decay[..., None, None]).add_(
        torch.einsum("bh,bhn,bhp->bhnp", dtv, bh, xh))
    y = torch.einsum("bhn,bhnp->bhp", chh, ssm)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, 1, di).to(x.dtype)
    return _gate_norm_out(p, y, z), state


# ---------------------------------------------------------------------------
# Full model (embedding + stacked mamba blocks)
# ---------------------------------------------------------------------------

def _block_specs(cfg) -> Dict[str, Any]:
    return {"ln": layers.norm_specs(cfg), "mixer": mamba_specs(cfg)}


def param_specs(cfg) -> Dict[str, Any]:
    return {
        "embed": layers.embed_specs(cfg),
        "layers": pspec.stack(_block_specs(cfg), cfg.n_layers),
        "ln_f": layers.norm_specs(cfg),
    }


def forward(cfg, params, tokens: torch.Tensor, *,
            window: Optional[int] = None, last_only: bool = False):
    """tokens: (B, S) ints -> logits (B, S, padded_vocab) and a zero aux
    loss; ``window`` is taken and unused, as in the JAX package."""
    x = layers.embed_tokens(cfg, params["embed"], tokens).to(
        torch_dtype(cfg.dtype))

    def body(x, lp):
        return x + mamba_forward(cfg, lp["mixer"],
                                 layers.apply_norm(cfg, lp["ln"], x))

    block = remat.checkpointed(cfg, body)
    for lp in unstack(params["layers"]):
        x = block(x, lp)
    if last_only:
        x = x[:, -1:]
    x = layers.apply_norm(cfg, params["ln_f"], x)
    return (layers.logits(cfg, params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def stacked_state(one: State, *lead: int) -> State:
    """Zeros shaped like ``one``'s leaves with the ``lead`` dims in front."""
    return {k: torch.zeros(tuple(lead) + tuple(a.shape), dtype=a.dtype,
                           device=a.device) for k, a in one.items()}


def init_decode_state(cfg, batch: int, max_len: int, *, window: int = 0,
                      device: DeviceLike = None):
    """Every layer's state stacked (``(L, ...)``, zeros) and the position
    counter; ``max_len`` and ``window`` do not size an SSM state."""
    one = init_mamba_state(cfg, batch, device)
    return {"cache": stacked_state(one, cfg.n_layers), "pos": 0}


def decode_step(cfg, params, state, tokens: torch.Tensor, *, window: int = 0):
    """One-token decode. tokens: (B,) ints. Returns (logits (B, V),
    new_state); the states are updated in place."""
    x = layers.embed_tokens(cfg, params["embed"], tokens[:, None]).to(
        torch_dtype(cfg.dtype))
    for i, lp in enumerate(unstack(params["layers"])):
        h = layers.apply_norm(cfg, lp["ln"], x)
        h, _ = mamba_decode(cfg, lp["mixer"], h,
                            {k: a[i] for k, a in state["cache"].items()})
        x = x + h
    x = layers.apply_norm(cfg, params["ln_f"], x)
    lg = layers.logits(cfg, params["embed"], x)[:, 0]
    return lg, {"cache": state["cache"], "pos": state["pos"] + 1}
