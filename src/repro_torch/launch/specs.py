"""Input specs: empty meta tensors standing in for every model input (port
of ``repro/launch/specs.py``).

Shapes and dtypes only, no memory: the dry run (``launch/dryrun_lib.py``)
runs ``train_step`` / ``prefill_step`` / ``serve_step`` on the meta device
against these. The audio / VLM frontends are stubs by assignment: seamless
gets precomputed frame embeddings (B, S, d_model); chameleon gets VQ token
ids in-vocab.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.common.config import InputShape, ModelConfig
from repro_torch.common.pspec import torch_dtype
from repro_torch.models import registry


def sds(shape, dtype) -> torch.Tensor:
    """An empty meta tensor of ``shape`` and ``dtype`` (a torch dtype or a
    config's dtype string)."""
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Inputs for train / prefill (full-sequence) steps."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {"tokens": sds((b, s), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = sds((b, s), torch.int32)
    if cfg.family == "encdec":
        specs["frames"] = sds((b, s, cfg.d_model), cfg.dtype)
    return specs


def decode_specs(cfg: ModelConfig, shape: InputShape, *, window: int = 0
                 ) -> Tuple[Any, Any]:
    """(decode state specs, token specs) for one-token serve steps."""
    b, s = shape.global_batch, shape.seq_len
    kw = {"src_len": min(s, 4096)} if cfg.family == "encdec" else {}
    state = registry.decode_state_specs(cfg, b, s, window=window, **kw)
    tokens = sds((b,), torch.int32)
    return state, tokens


def effective_window(cfg: ModelConfig, shape: InputShape) -> int:
    """long_500k runs attention archs with the sliding-window variant."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return cfg.long_context_window
    return cfg.sliding_window


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """The assignment's carve-outs, as in the JAX package."""
    if cfg.family == "encdec" and shape.name == "long_500k":
        return False, ("seamless enc-dec: 500k-frame encoder is quadratic; "
                       "decode bounded by target len (skip per DESIGN.md)")
    return True, ""
