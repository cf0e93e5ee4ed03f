"""Configuration of the port (a copy of ``repro/common/config.py:FFMConfig``).

The copy is kept field for field equal to the JAX package's dataclass; a
test holds the two together. ``ModelConfig`` comes with the LLM side.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class FFMConfig:
    """Configuration of the paper's DeepFFM (core contribution).

    Mirrors Fwumious Wabbit: hashed feature space, per-field embeddings of
    width ``k``, LR part, and an MLP head over the merged+normalized LR/FFM
    outputs (paper eq. Dffm).
    """

    n_fields: int = 24
    hash_space: int = 2**18
    k: int = 8  # FFM embedding width
    mlp_hidden: tuple = (64, 32)
    mlp_act: str = "relu"  # ReLU is what makes §4.3 sparse updates possible
    context_fields: int = 16  # first `context_fields` fields are the request context (§5)
    dtype: str = "float32"
    seed: int = 0

    @property
    def n_pairs(self) -> int:
        return self.n_fields * (self.n_fields - 1) // 2

    def replace(self, **kw) -> "FFMConfig":
        return dataclasses.replace(self, **kw)
