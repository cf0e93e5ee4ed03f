"""Context caching for FFM serving, paper §5 (port of
``repro/serving/context_cache.py``).

"Each request can be separated into context and candidates. For all
candidates in the request, the context is the same" — so the context-only
part of the forward pass is computed once per request and reused across the
candidate batch. For the DeepFFM the decomposition is exact: with fields
[0, Fc) the context and [Fc, F) the candidate, the pair set splits into
ctx-ctx pairs (cached), ctx-cand pairs (cached context rows against each
candidate's own) and cand-cand pairs (per candidate), and the LR sum into a
cached context part and a per-candidate part.

The cache is a prefix tree over ``(idx, val)`` field tokens whose lookups
reuse the deepest cached prefix; only the context *tail* is recomputed. The
decomposition and the trie live in :mod:`repro_torch.serving.engine`;
``CachedServer`` is the thin §5-only view over one
:class:`~repro_torch.serving.engine.InferenceEngine`, and its ``serve``
equals ``deepffm.forward`` on the full feature vector (``serve_uncached``).

The JAX view builds its engine on the ``"reference"`` backend; this one
takes the engine's default, ``"cuda"`` (the candidate kernels on the card,
their plain versions on the CPU).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.common.config import FFMConfig
from repro_torch.common.device import DeviceLike
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.prefix_cache import PrefixCache


class CachedServer:
    """Prefix-tree context cache in front of the candidate batch forward,
    with hit / miss counters and the underlying cache exposed for tests."""

    def __init__(self, cfg: FFMConfig, params: Dict, model: str = "deepffm",
                 max_entries: int = 4096, prefix_stride: Optional[int] = 4,
                 device: DeviceLike = None):
        self.engine = InferenceEngine(cfg, model, params=params,
                                      device=device,
                                      cache_entries=max_entries,
                                      prefix_stride=prefix_stride)

    @property
    def cfg(self) -> FFMConfig:
        return self.engine.cfg

    @property
    def model(self) -> str:
        return self.engine.model

    @property
    def params(self):
        return self.engine.params

    @params.setter
    def params(self, value):
        self.engine.install_params(value)

    @property
    def max_entries(self) -> int:
        return self.engine.cache_entries

    @property
    def hits(self) -> int:
        return self.engine.hits

    @property
    def misses(self) -> int:
        return self.engine.misses

    @property
    def _cache(self) -> PrefixCache:
        return self.engine._cache

    def serve(self, ctx_idx, ctx_val, cand_idx, cand_val) -> np.ndarray:
        """Score one request's candidates; logits (N,)."""
        return self.engine.score(ctx_idx, ctx_val, cand_idx, cand_val)

    def serve_uncached(self, ctx_idx, ctx_val, cand_idx,
                       cand_val) -> torch.Tensor:
        """Baseline: the full forward per candidate (the context recomputed
        each time); logits (N,) on the engine's device."""
        return self.engine.score_uncached(ctx_idx, ctx_val, cand_idx,
                                          cand_val)
