"""DeepFFM and its CTR baselines, forward pass (port of ``repro/core/deepffm.py``).

  Dffm(x) = FFNN( MergeNormLayer( LR(x), DiagMask(FFM(x)) ) )

Models: ``linear`` (hashed LR), ``mlp`` (LR + MLP over pooled field
embeddings), ``ffm`` (LR + summed DiagMask'd interactions) and ``deepffm``
(the paper's architecture). The MLP head's matrix products are plain
``torch.matmul``, as the JAX package leaves them to XLA. The forward
serves with plain ReLU layers; the training surface, :func:`loss_fn` and
:func:`loss_and_aux`, routes the hidden layers through
``sparse_updates.relu_linear``, whose ReLU-masked backward (§4.3) computes
each weight gradient with the block-skip kernel on the card.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common import pspec
from repro_torch.common.config import FFMConfig
from repro_torch.common.device import DeviceLike
from repro_torch.common.pspec import ParamSpec
from repro_torch.core import ffm, sparse_updates


def _mlp_specs(cfg: FFMConfig, d_in: int) -> Dict[str, Any]:
    dt = getattr(torch, cfg.dtype)
    sp = {}
    dims = (d_in,) + tuple(cfg.mlp_hidden) + (1,)
    for i in range(len(dims) - 1):
        # final layer zero-init: the MLP is a residual branch on top of the
        # additive LR/FFM terms, so it starts silent and learns its part
        init = "zeros" if i == len(dims) - 2 else "scaled"
        sp[f"w{i}"] = ParamSpec((dims[i], dims[i + 1]), ("null", "null"), init, dt)
        sp[f"b{i}"] = ParamSpec((dims[i + 1],), ("null",), "zeros", dt)
    return sp


def mlp_apply(cfg: FFMConfig, p, x: torch.Tensor, *,
              return_preacts: bool = False, return_masks: bool = False,
              sparse_backward: bool = False):
    """ReLU MLP head: (B, d_in) -> (B,).

    ``sparse_backward`` routes the hidden layers through
    :func:`sparse_updates.relu_linear`, the §4.3 zero-global-gradient
    backward (the activation mask applied before the weight-gradient
    product); the trainer's steps set it. Without it the layers are plain
    ReLU under autograd: the serving forward, and the gradient oracle.

    ``return_masks`` also returns the per-hidden-layer (B, H) activation
    masks that feed ``sparse_updates.skip_stats``; ``return_preacts`` the
    raw pre-activations.
    """
    n = len(cfg.mlp_hidden) + 1
    preacts, masks = [], []
    for i in range(n - 1):
        if sparse_backward and not return_preacts:
            x = sparse_updates.relu_linear(x, p[f"w{i}"], p[f"b{i}"])
        else:
            z = x @ p[f"w{i}"] + p[f"b{i}"]
            preacts.append(z)
            # no gradient at z == 0, as the masked backward (JAX's
            # jnp.maximum splits it; a tie has measure zero)
            x = torch.relu(z)
        if return_masks:  # relu(z) > 0 exactly where z > 0
            masks.append(x > 0)
    out = (x @ p[f"w{n - 1}"] + p[f"b{n - 1}"])[:, 0]
    if return_preacts:
        return out, preacts
    if return_masks:
        return out, masks
    return out


def param_specs(cfg: FFMConfig, model: str = "deepffm") -> Dict[str, Any]:
    lr = ffm.lr_specs(cfg)
    if model == "linear":
        return {"lr": lr}
    if model == "mlp":
        return {
            "lr": lr,
            "emb": ffm.ffm_specs(cfg)["emb"],
            "mlp": _mlp_specs(cfg, cfg.n_fields * cfg.k),
        }
    if model == "ffm":
        return {"lr": lr, "ffm": ffm.ffm_specs(cfg)}
    if model == "deepffm":
        d_merge = cfg.n_pairs + 1
        dt = getattr(torch, cfg.dtype)
        return {
            "lr": lr,
            "ffm": ffm.ffm_specs(cfg),
            "merge_scale": ParamSpec((d_merge,), ("null",), "ones", dt),
            "merge_bias": ParamSpec((d_merge,), ("null",), "zeros", dt),
            "mlp": _mlp_specs(cfg, d_merge),
        }
    raise ValueError(model)


def init_params(cfg: FFMConfig, seed: int = 0, model: str = "deepffm",
                device: DeviceLike = None):
    return pspec.materialize(param_specs(cfg, model), seed, device)


def merge_norm(cfg: FFMConfig, p, lr_out, ffm_vec):
    """MergeNormLayer: concat + normalization (learnable scale/bias)."""
    z = torch.cat([lr_out[:, None], ffm_vec], dim=-1)
    zf = z.to(torch.float32)
    mu = zf.mean(dim=-1, keepdim=True)
    var = zf.var(dim=-1, unbiased=False, keepdim=True)
    zn = (zf - mu) * torch.rsqrt(var + 1e-6)
    return (zn * p["merge_scale"] + p["merge_bias"]).to(z.dtype)


def head_from_parts(cfg: FFMConfig, params, lr_out, ffm_vec,
                    model: str = "deepffm", *, with_masks: bool = False,
                    sparse_backward: bool = False):
    """Shared ffm/deepffm tail: LR logits (B,) + pair vector (B, n_pairs)
    -> logits. For ``deepffm`` the FFNN over MergeNorm(LR, FFM) is a
    residual on top of the additive LR/FFM shortcut.

    ``with_masks`` returns ``(logits, masks)``, the MLP's per-hidden-layer
    activation masks (empty for ``ffm``) — the §4.3 zero-global-gradient
    structure the trainer reports per round."""
    base = lr_out + torch.sum(ffm_vec, dim=-1)
    if model == "ffm":
        return (base, []) if with_masks else base
    if model == "deepffm":
        z = merge_norm(cfg, params, lr_out, ffm_vec)
        out = mlp_apply(cfg, params["mlp"], z, return_masks=with_masks,
                        sparse_backward=sparse_backward)
        if with_masks:
            return base + out[0], out[1]
        return base + out
    raise ValueError(model)


def split_request(cfg: FFMConfig, idx, val):
    """Split full feature rows (B, F) sharing one context into
    ``(ctx_idx (Fc,), ctx_val (Fc,), cand_idx (B, F-Fc), cand_val (B, F-Fc))``."""
    fc = cfg.context_fields
    return idx[0, :fc], val[0, :fc], idx[:, fc:], val[:, fc:]


def forward(cfg: FFMConfig, params, idx, val, model: str = "deepffm",
            interactions_fn=None, *, with_masks: bool = False,
            sparse_backward: bool = False):
    """Returns logits (B,). ``interactions_fn`` lets the serving layer
    inject the kernel path (``kernels.ffm_interaction.ops.interactions``).
    ``with_masks`` returns ``(logits, masks)`` (see :func:`head_from_parts`).
    """
    lr_out = ffm.lr_forward(cfg, params["lr"], idx, val)
    if model == "linear":
        return (lr_out, []) if with_masks else lr_out
    if model == "mlp":
        e = ffm.gather_rows(params["emb"], idx)  # (B,F,F,k)
        pooled = (e.mean(dim=2) * val[..., None]).reshape(idx.shape[0], -1)
        out = mlp_apply(cfg, params["mlp"], pooled, return_masks=with_masks,
                        sparse_backward=sparse_backward)
        if with_masks:
            return lr_out + out[0], out[1]
        return lr_out + out
    inter = interactions_fn or ffm.interactions
    ffm_vec = inter(cfg, params["ffm"]["emb"], idx, val)
    return head_from_parts(cfg, params, lr_out, ffm_vec, model,
                           with_masks=with_masks,
                           sparse_backward=sparse_backward)


def loss_fn(cfg: FFMConfig, params, batch, model: str = "deepffm",
            sparse_backward: bool = True) -> torch.Tensor:
    """Mean binary cross-entropy of ``batch`` (``idx``, ``val``, ``label``
    tensors); its gradient takes the §4.3 backward unless
    ``sparse_backward=False`` (plain autograd, the oracle)."""
    logits = forward(cfg, params, batch["idx"], batch["val"], model,
                     sparse_backward=sparse_backward)
    return ffm.bce_loss(logits, batch["label"])


def loss_and_aux(cfg: FFMConfig, params, batch, model: str = "deepffm"):
    """Loss (with the §4.3 backward) plus the trainer's aux: the logits
    (progressive-validation scores come from the same forward the gradient
    uses) and the §4.3 activation masks."""
    logits, masks = forward(cfg, params, batch["idx"], batch["val"], model,
                            with_masks=True, sparse_backward=True)
    return ffm.bce_loss(logits, batch["label"]), {"logits": logits,
                                                  "masks": masks}


def predict_proba(cfg: FFMConfig, params, idx, val, model: str = "deepffm"):
    return torch.sigmoid(forward(cfg, params, idx, val, model))
