"""Synthetic CTR data (a copy of ``repro/data/synthetic.py``; numpy only).

``CTRStream`` is a click-through-rate stream with real field-pair
interaction structure (so FFM-class models beat linear ones, as in the
paper's Table 1) plus optional distribution drift. Features are hashed as
Fwumious Wabbit hashes them: each (field, raw value) pair maps to one index
in a single shared hash space. The same seed gives the same batches as the
JAX package's stream, bit for bit; so does ``lm_batches``, the LLM
training stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.common.config import FFMConfig

_P1, _P2 = np.uint64(0x9E3779B97F4A7C15), np.uint64(0xBF58476D1CE4E5B9)


def feature_hash(field: np.ndarray, value: np.ndarray, hash_space: int) -> np.ndarray:
    h = (field.astype(np.uint64) + np.uint64(1)) * _P1 ^ (
        value.astype(np.uint64) + np.uint64(1)
    ) * _P2
    h ^= h >> np.uint64(31)
    return (h % np.uint64(hash_space)).astype(np.int32)


@dataclass
class CTRStream:
    cfg: FFMConfig
    vocab_per_field: int = 100
    latent_dim: int = 4
    n_numeric: int = 4  # last fields carry log-transformed continuous values
    drift: float = 0.0  # per-batch rotation of the latent structure
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        f, v, d = self.cfg.n_fields, self.vocab_per_field, self.latent_dim
        self.field_bias = rng.normal(0, 0.3, (f, v))
        self.latent = rng.normal(0, 1.0, (f, v, d)) / np.sqrt(d)
        # sparse, interaction-dominant field-pair structure (most pairs
        # inert): FFM-class models must be able to exploit it
        strength = rng.normal(0, 2.0, (f, f)) * (rng.random((f, f)) < 0.4)
        self.pair_strength = np.triu(strength, 1)
        self.bias = -0.5
        self._rng = rng
        self._t = 0

    def sample(self, batch: int) -> Dict[str, np.ndarray]:
        cfg, rng = self.cfg, self._rng
        f, v = cfg.n_fields, self.vocab_per_field
        raw = rng.integers(0, v, (batch, f))
        vals = np.ones((batch, f), np.float32)
        if self.n_numeric:
            numeric = rng.lognormal(0.0, 1.0, (batch, self.n_numeric))
            vals[:, -self.n_numeric :] = np.log1p(numeric)  # paper: log transform

        if self.drift:
            theta = self.drift * self._t
            rot = np.eye(self.latent_dim)
            rot[0, 0] = rot[1, 1] = np.cos(theta)
            rot[0, 1], rot[1, 0] = -np.sin(theta), np.sin(theta)
            latent = self.latent @ rot
        else:
            latent = self.latent
        self._t += 1

        # ground truth is value-weighted as an FFM consumes features:
        # numeric fields contribute latent * value
        lin = (self.field_bias[np.arange(f)[None, :], raw] * vals).sum(axis=1)
        emb = latent[np.arange(f)[None, :], raw] * vals[..., None]  # (B, F, d)
        inter = np.einsum("bid,bjd,ij->b", emb, emb, self.pair_strength)
        score = self.bias + 0.3 * lin + 1.5 * inter / np.sqrt(f)
        p = 1.0 / (1.0 + np.exp(-score))
        labels = (rng.random(batch) < p).astype(np.float32)

        idx = feature_hash(
            np.broadcast_to(np.arange(f)[None, :], raw.shape), raw, cfg.hash_space
        )
        return {"idx": idx, "val": vals, "label": labels}

    def batches(self, batch: int, n: int) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(n):
            yield self.sample(batch)

    def request(self, n_candidates: int):
        """A serving request: one shared context + N candidate completions."""
        fc = self.cfg.context_fields
        full = self.sample(n_candidates)
        ctx_idx, ctx_val = full["idx"][0, :fc], full["val"][0, :fc]
        return ctx_idx, ctx_val, full["idx"][:, fc:], full["val"][:, fc:]


def lm_batches(vocab: int, batch: int, seq: int, n: int, seed: int = 0
               ) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-ish synthetic token stream (learnable, not uniform noise):
    ``n`` batches of ``tokens`` and next-token ``labels``, (batch, seq)
    int32 each."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(0, vocab, (vocab, 4))
    for _ in range(n):
        toks = np.zeros((batch, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, vocab, batch)
        for t in range(seq):
            choice = rng.integers(0, 4, batch)
            nxt = trans[toks[:, t], choice]
            noise = rng.random(batch) < 0.1
            toks[:, t + 1] = np.where(noise, rng.integers(0, vocab, batch), nxt)
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
