"""Shared by the benchmark's tests: the harness on the import path, and a
cell cut to a size that a CPU test run holds (a 4,096-row hash space,
vocabularies of at most 1,000 values, small pools and slates; every width
of the configuration kept)."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import spec  # noqa: E402

CELLS = ("deepffm-100m.serve-slates", "ffm-50m.serve-fused",
         "deepffm-100m.train-online")
SEED = 2**31 + 11


def shrink(cell: spec.Cell) -> spec.Cell:
    c = dict(cell.config, hash_space=4096)
    m = dict(cell.mix, values_per_field=[min(v, 1000)
                                         for v in cell.mix["values_per_field"]])
    if m["loop"] == "serve":
        m.update(pool_calls=40, warmup_calls=4,
                 requests_per_call=min(m["requests_per_call"], 8),
                 candidates=dict(lo=4, hi=min(m["candidates"]["hi"], 32)))
    else:
        m.update(microbatch=64, microbatches_per_round=4,
                 pool_microbatches=12)
    return dataclasses.replace(cell, config=c, mix=m)


def tiny_cell(name: str) -> spec.Cell:
    return shrink(spec.load_cell(ROOT / "BENCHMARK.json", name))
