"""The yardstick's operation and byte counts, and the chip's published
peaks. Frozen here so that a change to the program cannot move what its
rooflines and ``mfu`` are divided by.

``k1_work``, ``k3_work`` and ``k5_work`` are copies of the program's
booking formulas (``kernels/row_gather/ops.py:k1_work``,
``kernels/ffm_interaction/ops.py:_candidate_work`` / ``_fused_work``) as
they stood when this benchmark was written. Each counts what the kernel's
function needs: every input read once, every output written once. The
serving counts are taken over the rows that were scored (after dedup,
before padding), so they never count padding as work.
"""
from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense: f32 outside the tensor cores, HBM3
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def bound_seconds(flops: float, nbytes: float, precision: str = "float32"
                  ) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES_PER_S)


def k1_work(m: int, rowlen: int) -> Tuple[int, int]:
    """K1: gather ``m`` int8 rows of ``rowlen`` codes and dequantize."""
    return 2 * m * rowlen, m * (rowlen + 4 + 8) + m * rowlen * 4


def _candidate_work(r, n, fc, fcand, k, q8: bool):
    rnc = r * n * fcand
    outs = r * n * (fc * fcand + fcand * fcand)
    ctx = r * (fc * fcand * k + fc) * 4 + rnc * 4
    f = fc + fcand
    if q8:
        return (outs * (2 * k + 2) + rnc * f * k * 2,
                ctx + rnc * (f * k + 8) + outs * 4)
    return outs * (2 * k + 2), ctx + rnc * f * k * 4 + outs * 4


def k3_work(r: int, n: int, fc: int, fcand: int, k: int):
    """K3: ctx x cand and cand x cand dot matrices over int8 codes."""
    return _candidate_work(r, n, fc, fcand, k, True)


def k5_work(r: int, n: int, fc: int, fcand: int, k: int):
    """K5: one fused bucket over int8 codes (logits and ctx pair matrix)."""
    f = fc + fcand
    rnc = r * n * fcand
    n_aa = fcand * (fcand - 1) // 2
    io = (r * (fc * f * k + fc + 1 + fc * fc) * 4 + r * n * 2 * 4
          + rnc * 4)
    per_cand = (fc * fcand * (2 * k + 3 + (k + 3))
                + n_aa * (2 * k + 3 + (4 * k + 10)) + 3)
    flops = r * fc * fc * (2 * k + 3) + r * n * per_cand
    return flops, io + rnc * (f * k + 8)


def mlp_dims(cfg: Dict) -> Tuple[int, ...]:
    n_pairs = cfg["n_fields"] * (cfg["n_fields"] - 1) // 2
    return (n_pairs + 1,) + tuple(cfg["mlp_hidden"]) + (1,)


def head_work(cfg: Dict, rows: int) -> Tuple[int, int]:
    """The ``deepffm`` head's matrix products over ``rows`` rows: two
    operations a multiply-add, each layer's input read and output written
    once (the weights, read once a call, are left out: a lower bound)."""
    if cfg["model"] != "deepffm":
        return 0, 0
    d = mlp_dims(cfg)
    flops = sum(2 * a * b for a, b in zip(d[:-1], d[1:]))
    nbytes = sum(a + b for a, b in zip(d[:-1], d[1:])) * 4
    return rows * flops, rows * nbytes


def forward_row_flops(cfg: Dict) -> int:
    """Operations of one full forward row (the plain reference's
    arithmetic): the DiagMask pairs (a k-dot and two value products each),
    LR, and for ``deepffm`` MergeNorm and the MLP."""
    f, k = cfg["n_fields"], cfg["k"]
    n_pairs = f * (f - 1) // 2
    flops = n_pairs * (2 * k + 2) + 2 * f + n_pairs + 2
    if cfg["model"] == "deepffm":
        d = mlp_dims(cfg)
        flops += 6 * d[0] + sum(2 * a * b + b for a, b in zip(d[:-1], d[1:]))
    return flops


def serve_row_flops(cfg: Dict) -> int:
    """Operations the scoring step needs for one scored (context, ad)
    row, the context's cached part left out: the candidate pairs (K3's
    or K5's count for one row), its LR terms, and the head."""
    fc, f, k = cfg["context_fields"], cfg["n_fields"], cfg["k"]
    fcand = f - fc
    if cfg.get("fused"):
        flops, _ = k5_work(1, 1, fc, fcand, k)
        flops -= fc * fc * (2 * k + 3)  # the ctx pair matrix, a context's
    else:
        flops, _ = k3_work(1, 1, fc, fcand, k)
    flops += 2 * fcand + f * (f - 1) // 2
    return flops + head_work(cfg, 1)[0]


def train_example_flops(cfg: Dict) -> int:
    """Forward and backward of one training example: three times the
    forward (the backward's two products per forward product)."""
    return 3 * forward_row_flops(cfg)
