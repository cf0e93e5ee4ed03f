"""Architecture registry (port of ``repro/models/registry.py``): arch id ->
config, family -> module.

Every arch id of the JAX package is ported (:data:`ARCH_IDS`): the
``dense``, ``vlm`` and ``moe`` families with GQA attention or deepseek-v2's
MLA (:mod:`transformer`), the ``encdec`` family (:mod:`encdec`), ``ssm``
(:mod:`ssm`, mamba2) and ``hybrid`` (:mod:`hybrid`, zamba2). As in the JAX
package, ``encdec`` takes the whole batch (``frames`` and ``tokens``) in
:func:`forward` and :func:`loss_fn`, and ``src_len`` in
:func:`init_decode_state`.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

from repro_torch.common import pspec
from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike
from repro_torch.models import encdec, hybrid, layers, ssm, transformer

FAMILY_MODULES = {"dense": transformer, "vlm": transformer,
                  "moe": transformer, "ssm": ssm, "hybrid": hybrid,
                  "encdec": encdec}

_MODULE_FOR_ARCH = {
    "chameleon-34b": "chameleon_34b",
    "mamba2-130m": "mamba2_130m",
    "yi-6b": "yi_6b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "llama3.2-1b": "llama32_1b",
    "qwen2.5-3b": "qwen25_3b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "zamba2-7b": "zamba2_7b",
    "granite-8b": "granite_8b",
}

ARCH_IDS = tuple(_MODULE_FOR_ARCH)


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported (ported: {', '.join(ARCH_IDS)}, every arch "
        "id of the JAX package; ROADMAP.md Queue 1 lists what remains)")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULE_FOR_ARCH:
        raise _unported(f"arch {arch_id!r}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_MODULE_FOR_ARCH[arch_id]}")
    return mod.smoke() if smoke else mod.config()


def module_for(cfg: ModelConfig):
    if cfg.family not in FAMILY_MODULES:
        raise _unported(f"family {cfg.family!r}")
    return FAMILY_MODULES[cfg.family]


def param_specs(cfg: ModelConfig):
    return module_for(cfg).param_specs(cfg)


def abstract_params(cfg: ModelConfig):
    """Every leaf as an empty meta tensor of its spec's shape and dtype."""
    return pspec.abstract(param_specs(cfg))


def param_axes(cfg: ModelConfig):
    return pspec.axes(param_specs(cfg))


def init_params(cfg: ModelConfig, seed: int, device: DeviceLike = None):
    """Random weights from ``seed`` on ``device`` (the card by default)."""
    return pspec.materialize(param_specs(cfg), seed, device)


def forward(cfg: ModelConfig, params, batch: Dict[str, Any], rt=None, *,
            window=None, last_only: bool = False):
    """``rt`` (a mesh's runtime, ``common/runtime.py``) reaches the
    transformer families, whose MoE layers use it; the other families have
    no layer that reads it, as in the JAX package. ``last_only`` gives the
    last position's logits (B, 1, V) only: the prefill step's."""
    mod = module_for(cfg)
    if cfg.family == "encdec":
        return mod.forward(cfg, params, batch, window=window,
                           last_only=last_only)
    if mod is transformer:
        return mod.forward(cfg, params, batch["tokens"], rt, window=window,
                           last_only=last_only)
    return mod.forward(cfg, params, batch["tokens"], window=window,
                       last_only=last_only)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, Any], rt=None, *,
            window=None):
    """The training loss: mean cross-entropy of the forward's logits against
    ``batch["labels"]`` (< 0 masked) plus ``router_aux_coef`` times the
    routers' aux loss. Returns ``(loss, {"ce", "aux"})``. Under a mesh
    (``rt``) the batch is this rank's rows, and so is the cross-entropy's
    mean; aux is the global value."""
    logits, aux = forward(cfg, params, batch, rt, window=window)
    ce = layers.cross_entropy(logits, batch["labels"], cfg.padded_vocab)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      window: int = 0, device: DeviceLike = None, **kw):
    """``kw`` (``src_len``) reaches the ``encdec`` family only."""
    mod = module_for(cfg)
    if cfg.family == "encdec":
        return mod.init_decode_state(cfg, batch, max_len, window=window,
                                     device=device, **kw)
    return mod.init_decode_state(cfg, batch, max_len, window=window,
                                 device=device)


def decode_state_specs(cfg: ModelConfig, batch: int, max_len: int, *,
                       window: int = 0, **kw):
    """:func:`init_decode_state` on the meta device: the state's shapes and
    dtypes, no memory (``pos`` stays the Python int 0)."""
    return init_decode_state(cfg, batch, max_len, window=window,
                             device="meta", **kw)


def decode_step(cfg: ModelConfig, params, state, tokens, *, window: int = 0):
    return module_for(cfg).decode_step(cfg, params, state, tokens,
                                       window=window)
