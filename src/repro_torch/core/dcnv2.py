"""DCNv2 baseline (paper §2.2; port of ``repro/core/dcnv2.py``). [Wang et
al., WWW'21]

Cross layers ``x_{l+1} = x0 * (x_l W_l + b_l) + x_l`` over the concatenated
field embeddings, then a ReLU MLP head. The paper assigned each value a
unique hash for this baseline; the hashed feature indices are reused. The
JAX package has no kernel here, so the port is stock torch: its gradients
come from autograd.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common import pspec
from repro_torch.common.config import FFMConfig
from repro_torch.common.device import DeviceLike
from repro_torch.common.pspec import ParamSpec, torch_dtype
from repro_torch.core import ffm

K_DENSE = 8  # embedding width per field


def param_specs(cfg: FFMConfig, n_cross: int = 3,
                mlp_hidden=(64, 32)) -> Dict[str, Any]:
    dt = torch_dtype(cfg.dtype)
    d0 = cfg.n_fields * K_DENSE
    sp: Dict[str, Any] = {
        "emb": ParamSpec((cfg.hash_space, K_DENSE), ("vocab", "null"),
                         "embed", dt),
    }
    for i in range(n_cross):
        sp[f"cross_w{i}"] = ParamSpec((d0, d0), ("null", "null"), "scaled", dt)
        sp[f"cross_b{i}"] = ParamSpec((d0,), ("null",), "zeros", dt)
    dims = (d0,) + tuple(mlp_hidden) + (1,)
    for i in range(len(dims) - 1):
        sp[f"mlp_w{i}"] = ParamSpec((dims[i], dims[i + 1]), ("null", "null"),
                                    "scaled", dt)
        sp[f"mlp_b{i}"] = ParamSpec((dims[i + 1],), ("null",), "zeros", dt)
    return sp


def init_params(cfg: FFMConfig, seed: int = 0, device: DeviceLike = None,
                n_cross: int = 3, mlp_hidden=(64, 32)):
    """Random weights from ``seed`` on ``device`` (the card by default)."""
    return pspec.materialize(param_specs(cfg, n_cross, mlp_hidden), seed,
                             device)


def forward(cfg: FFMConfig, params, idx: torch.Tensor, val: torch.Tensor,
            n_cross: int = 3) -> torch.Tensor:
    """idx, val: (B, F) -> logits (B,). Up to ``n_cross`` cross layers and
    every MLP layer that ``params`` holds."""
    x0 = (params["emb"][idx] * val[..., None]).reshape(idx.shape[0], -1)
    x = x0
    for i in range(n_cross):
        if f"cross_w{i}" not in params:
            break
        x = x0 * (x @ params[f"cross_w{i}"] + params[f"cross_b{i}"]) + x
    i = 0
    while f"mlp_w{i + 1}" in params:
        x = torch.relu(x @ params[f"mlp_w{i}"] + params[f"mlp_b{i}"])
        i += 1
    x = x @ params[f"mlp_w{i}"] + params[f"mlp_b{i}"]
    return x[:, 0]


def loss_fn(cfg: FFMConfig, params, batch) -> torch.Tensor:
    """Mean binary cross-entropy of ``batch`` (``idx``, ``val``, ``label``
    tensors)."""
    return ffm.bce_loss(forward(cfg, params, batch["idx"], batch["val"]),
                        batch["label"])
