"""The one traffic generator of the benchmark: every mix is a JSON file of
parameters under ``traffic/`` that this module reads.

Every field's raw value is a seeded Zipf draw over that field's vocabulary
(``values_per_field``, one number a field, context fields first), and is
hashed as Fwumious Wabbit hashes it (``feature_hash``: one index per
(field, raw value) pair in one shared hash space, a frozen copy of the
program's hash). The mixes take the vocabularies of a public CTR log
(their ``sources`` say which), so a large table is touched the way such
traffic touches it: a heavy head and a long tail that no cache holds.

Serving mixes (``"loop": "serve"``) make a pool of calls. A call is a
list of requests; a request is a context (the first ``Fc`` fields) and a
slate of candidates, each a row of ``F - Fc`` fields. Training mixes
(``"loop": "train"``) make a pool of labelled microbatches. Everything is
drawn from ``--seed`` alone: the same seed gives the same pool, bit for
bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

_P1, _P2 = np.uint64(0x9E3779B97F4A7C15), np.uint64(0xBF58476D1CE4E5B9)


def feature_hash(field, value, hash_space: int) -> np.ndarray:
    """(field, raw value) -> row of the hash space (int32)."""
    field = np.asarray(field)
    value = np.asarray(value)
    h = (field.astype(np.uint64) + np.uint64(1)) * _P1 ^ (
        value.astype(np.uint64) + np.uint64(1)) * _P2
    h ^= h >> np.uint64(31)
    return (h % np.uint64(hash_space)).astype(np.int32)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for one named stream of one seed (any
    non-negative seed, 64-bit and beyond)."""
    return np.random.default_rng([int(seed) % (1 << 63), int(seed) >> 63,
                                  *map(int, stream)])


class Zipf:
    """Draws ranks 0..n-1 with P(r) proportional to (r + 1)^-s (a bounded
    vocabulary, unlike ``numpy``'s unbounded Zipf) by inverting the CDF on
    ``device`` (uniform draws from the host's generator)."""

    def __init__(self, n: int, s: float, device="cpu"):
        import torch

        w = torch.arange(1, n + 1, dtype=torch.float64, device=device)
        cdf = torch.cumsum(w.pow_(-float(s)), 0)
        self.n, self.device = n, device
        self.cdf = cdf / cdf[-1]

    def draw(self, rng: np.random.Generator, size) -> np.ndarray:
        import torch

        u = torch.from_numpy(rng.random(size)).to(self.device)
        r = torch.searchsorted(self.cdf, u, right=True).clamp_(max=self.n - 1)
        return r.cpu().numpy()


class Fields:
    """Rows of the fields ``lo``..``hi - 1``: each field's raw value a Zipf
    draw over its own vocabulary, hashed with its field number."""

    def __init__(self, cfg: Dict, mix: Dict, lo: int, hi: int, device="cpu"):
        vocab = mix["values_per_field"]
        if len(vocab) != cfg["n_fields"]:
            raise ValueError(f"values_per_field names {len(vocab)} fields, "
                             f"the configuration has {cfg['n_fields']}")
        s = float(mix["zipf_s"])
        self.fields = np.arange(lo, hi)
        self.zipf = [Zipf(int(vocab[f]), s, device) for f in self.fields]
        self.v = cfg["hash_space"]

    def draw(self, rng: np.random.Generator, count: int) -> np.ndarray:
        """``count`` rows, (count, hi - lo) int32."""
        raw = np.stack([z.draw(rng, count) for z in self.zipf], axis=1)
        return feature_hash(self.fields, raw, self.v)


def sizes(rng: np.random.Generator, spec: Dict, count: int) -> np.ndarray:
    """Slate sizes of one call: the ``count`` quantiles of the log-uniform
    distribution over ``lo``..``hi`` at ``(i + 1/2) / count``, in an order
    drawn from the seed. Every call, of every seed, holds the same sizes,
    so a seed changes which candidates and contexts come, never how much
    work a call is."""
    lo, hi = int(spec["lo"]), int(spec["hi"])
    q = (np.arange(count) + 0.5) / count
    x = np.exp(np.log(lo) + q * (np.log(hi + 1) - np.log(lo)))
    return rng.permutation(np.clip(x.astype(np.int64), lo, hi))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@dataclass
class ServePool:
    """A run's calls, each a list of ``score_batch`` requests: (ctx_idx
    (Fc,) int32, ctx_val (Fc,) float32, cand_idx (n, F - Fc) int32,
    cand_val (n, F - Fc) float32). Every field is categorical: values 1."""

    calls: List[List[tuple]]
    warmup: List[List[tuple]]


def _calls(cfg, mix, seed, stream, count, ctx, cand) -> List[List[tuple]]:
    rng = rng_for(seed, stream)
    fc, f = cfg["context_fields"], cfg["n_fields"]
    per = int(mix["requests_per_call"])
    ns = [sizes(rng, mix["candidates"], per) for _ in range(count)]
    # one draw a field for the whole pool, cut into calls and requests
    ci = ctx.draw(rng, count * per).reshape(count, per, fc)
    rows = cand.draw(rng, int(sum(n.sum() for n in ns)))
    ones_c, ones_r = np.ones(fc, np.float32), np.ones((1, f - fc), np.float32)
    out, at = [], 0
    for c in range(count):
        call = []
        for j, n in enumerate(ns[c]):
            block = rows[at:at + n]
            call.append((ci[c, j], ones_c, block,
                         np.broadcast_to(ones_r, block.shape)))
            at += n
        out.append(call)
    return out


def make_serve_pool(cfg: Dict, mix: Dict, seed: int, device="cpu"
                    ) -> ServePool:
    fc, f = cfg["context_fields"], cfg["n_fields"]
    fields = (Fields(cfg, mix, 0, fc, device), Fields(cfg, mix, fc, f, device))
    return ServePool(
        _calls(cfg, mix, seed, 3, int(mix["pool_calls"]), *fields),
        _calls(cfg, mix, seed, 4, int(mix["warmup_calls"]), *fields))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def make_train_pool(cfg: Dict, mix: Dict, seed: int, device="cpu"
                    ) -> List[Dict[str, np.ndarray]]:
    """``pool_microbatches`` microbatches of ``microbatch`` examples, every
    field categorical, labels drawn from a seeded logistic rule over the
    hashed features (a weight per row and field pairs that interact), so
    the loss can fall."""
    f, v = cfg["n_fields"], cfg["hash_space"]
    b, m = int(mix["microbatch"]), int(mix["pool_microbatches"])
    rng = rng_for(seed, 5)
    rows = Fields(cfg, mix, 0, f, device)
    w_row = rng.normal(0.0, 0.5, v).astype(np.float32)
    u_row = rng.normal(0.0, 0.5, v).astype(np.float32)
    pairs = rng.integers(0, f, (int(mix["label_pairs"]), 2))
    ones = np.ones((b, f), np.float32)
    out = []
    for _ in range(m):
        idx = rows.draw(rng, b)
        score = w_row[idx].sum(1) / np.sqrt(f)
        score += sum(u_row[idx[:, i]] * u_row[idx[:, j]] for i, j in pairs)
        p = 1.0 / (1.0 + np.exp(-(score - 1.0)))
        label = (rng.random(b) < p).astype(np.float32)
        out.append({"idx": idx, "val": ones, "label": label})
    return out
