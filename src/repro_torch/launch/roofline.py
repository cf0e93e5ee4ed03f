"""Roofline report of a dry-run step (port of the report half of
``repro/launch/roofline.py``; its serving half waits for ROADMAP.md Queue 1
item 2).

The dry run (``launch/dryrun_lib.py``) counts one rank's step on the meta
device (``launch/op_analysis.py``); the three roofline terms follow from
the counts and the card's peaks:

  compute    = counted FLOPs            / (chips * peak FLOP/s of the dtype)
  memory     = counted bytes            / (chips * HBM B/s)
  collective = counted collective bytes / (chips * link B/s)

Counts are per rank; the report holds them times the chip count, as the
JAX package's does. MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D
(forward-style steps); the ratio MODEL_FLOPS / counted FLOPs flags repeated
or redundant compute.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

# NVIDIA H100 SXM5 80 GB, spec-sheet figures (NVIDIA's H100 datasheet,
# dense rates without sparsity, at the full 700 W power limit): not
# measurements. f32 is the CUDA-core rate (TF32 stays off in the port).
# The link rate is one 400 Gb/s NDR InfiniBand port per GPU: every group of
# the 16 x 16 and 2 x 16 x 16 meshes spans more than one 8-GPU NVLink node,
# so a collective runs at the slowest link it crosses.
H100_SXM = {
    "device": "NVIDIA H100 80GB HBM3, 700 W (spec sheet)",
    "flops_bfloat16": 989e12,  # FLOP/s per card
    "flops_float32": 67e12,
    "hbm_bw": 3.35e12,  # B/s
    "link_bw": 50e9,  # B/s per card (400 Gb/s)
    "hbm_bytes": 80e9,
}


@dataclass
class RooflineReport:
    """JAX's report with ``hlo_flops`` / ``hlo_bytes`` named
    ``counted_flops`` / ``counted_bytes`` and the step's ``dtype`` added,
    whose peak ``t_compute`` uses."""

    arch: str
    shape: str
    mesh: str
    chips: int
    counted_flops: float
    counted_bytes: float
    collective_bytes: float
    model_flops: float
    n_layer_trips: int = 1  # the port unrolls its layers: always 1
    collective_detail: Dict[str, int] = field(default_factory=dict)
    memory_per_device: Optional[Dict[str, float]] = None
    dtype: str = "bfloat16"

    @property
    def t_compute(self) -> float:
        return self.counted_flops / (self.chips
                                     * H100_SXM[f"flops_{self.dtype}"])

    @property
    def t_memory(self) -> float:
        return self.counted_bytes / (self.chips * H100_SXM["hbm_bw"])

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * H100_SXM["link_bw"])

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.counted_flops, 1.0)

    @property
    def step_time_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(
            t_compute=self.t_compute,
            t_memory=self.t_memory,
            t_collective=self.t_collective,
            bottleneck=self.bottleneck,
            useful_flops_ratio=self.useful_flops_ratio,
            step_time_bound=self.step_time_bound,
        )
        return d


def build_report(*, arch: str, shape: str, mesh_name: str, chips: int,
                 counter, model_flops: float, dtype: str,
                 memory_per_device: Optional[Dict[str, float]] = None
                 ) -> RooflineReport:
    """The report of one rank's counted step (``counter``, an
    ``op_analysis.Counter``), every rank taken to do as much;
    ``memory_per_device``: the rank's argument, output and peak bytes."""
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        counted_flops=counter.flops * chips,
        counted_bytes=counter.bytes * chips,
        collective_bytes=counter.collective_bytes * chips,
        model_flops=model_flops,
        collective_detail=counter.collective_stats(),
        memory_per_device=memory_per_device,
        dtype=dtype,
    )
