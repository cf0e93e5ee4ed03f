"""Step factories over the model registry (port of
``repro/train/steps.py``'s serve step). The train and prefill steps come
with LLM training (ROADMAP.md Queue 1, LLM side)."""
from __future__ import annotations

import torch

from repro_torch.models import registry


def make_serve_step(cfg, *, window: int = 0):
    """One-token greedy decode step: ``(params, state, tokens (B,)) ->
    (next tokens (B,) int32, new state)``."""

    def serve_step(params, state, tokens):
        logits, new_state = registry.decode_step(cfg, params, state, tokens,
                                                 window=window)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_state

    return serve_step
