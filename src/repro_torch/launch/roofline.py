"""Roofline reports (port of ``repro/launch/roofline.py``): a dry-run
step's, and a serving engine's bytes-per-prediction bound.

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

The serving roofline (:func:`serving_roofline`) bounds an engine's
predictions per second by the bytes a prediction moves: the ops its
deployed candidate forward dispatches, counted by ``op_analysis.Counter``
(where the JAX package walks the forward's HLO), over the bandwidth of the
memory the forward reads, plus the host pre-gather's analytic bytes over the
host's bandwidth.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# Serving roofline: predictions per second against memory bandwidth
# ---------------------------------------------------------------------------

def measure_cpu_bandwidth(nbytes: int = 1 << 26, repeats: int = 3,
                          streams: int = 1) -> float:
    """Sustained host memory bandwidth in B/s, measured with a numpy block
    copy (read + write of ``nbytes``; best of ``repeats``).

    ``streams`` > 1 measures the bandwidth the parallel scoring pipeline's
    threads compete for: that many threads each copy their own ``nbytes``
    block at once (numpy's ``copyto`` releases the GIL), and the aggregate
    bytes over the slowest stream's wall time is returned."""
    streams = max(1, int(streams))
    srcs = [np.ones(nbytes, np.uint8) for _ in range(streams)]
    dsts = [np.empty_like(s) for s in srcs]
    if streams == 1:
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            np.copyto(dsts[0], srcs[0])
            best = min(best, time.perf_counter() - t0)
        return 2.0 * nbytes / max(best, 1e-12)

    start = threading.Barrier(streams + 1)

    def copy_stream(i):
        start.wait()
        np.copyto(dsts[i], srcs[i])

    best = float("inf")
    for _ in range(repeats):
        threads = [threading.Thread(target=copy_stream, args=(i,))
                   for i in range(streams)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        best = min(best, time.perf_counter() - t0)
    return streams * 2.0 * nbytes / max(best, 1e-12)


def measure_device_bandwidth(device, nbytes: int = 1 << 28,
                             repeats: int = 5) -> float:
    """The card's memory bandwidth in B/s: a device-to-device copy of
    ``nbytes`` (read + write), timed with CUDA events after one warm copy;
    the best of ``repeats``. Raises on a device that is not CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_device_bandwidth needs a CUDA device, "
                         f"got {dev}")
    src = torch.ones(nbytes, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    best = float("inf")
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        dst.copy_(src)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return 2.0 * nbytes / max(best, 1e-12)


@dataclass
class ServingRoofline:
    """Bytes-per-prediction roofline of one serving configuration (JAX's
    ``ServingRoofline``).

    ``counted_bytes_per_call`` / ``counted_flops_per_call`` are what JAX
    names ``hlo_bytes_per_call`` / ``hlo_flops_per_call``: the op count of
    the engine's deployed forward (``InferenceEngine.
    lower_candidates_forward``, counted by ``op_analysis.Counter``).
    ``host_bytes_per_call`` is the host pre-gather's analytic traffic
    (``InferenceEngine.host_gather_bytes``). ``bound_preds_per_s`` is the
    ceiling those bytes imply; ``fraction_of_bound`` puts the measured
    throughput against it.

    One field JAX lacks: ``host_bandwidth_bytes_per_s``. JAX's forward and
    its pre-gather both read host memory, one bandwidth; on the card the
    forward reads device memory and the pre-gather host memory. When it is
    set, the bound is ``1 / (counted bytes per prediction / bandwidth +
    host bytes per prediction / host bandwidth)``; when ``None`` (a CPU
    engine), every property is JAX's formula. The aggregate (multi-stream)
    fields, given when the record is built by hand (``serving_roofline``
    leaves them unset), replace the host bandwidth alone, or on a CPU
    engine the one bandwidth, as in JAX.
    """

    scenario: str
    predictions_per_call: int
    counted_bytes_per_call: float
    host_bytes_per_call: float
    counted_flops_per_call: float
    measured_preds_per_s: float
    bandwidth_bytes_per_s: float
    streams: int = 1
    aggregate_bandwidth_bytes_per_s: Optional[float] = None
    aggregate_measured_preds_per_s: Optional[float] = None
    host_bandwidth_bytes_per_s: Optional[float] = None

    @property
    def bytes_per_prediction(self) -> float:
        return ((self.counted_bytes_per_call + self.host_bytes_per_call)
                / max(self.predictions_per_call, 1))

    def _bound(self, host_bw: float) -> float:
        """Predictions per second with the forward's bytes at the device
        bandwidth and the pre-gather's at ``host_bw``."""
        n = max(self.predictions_per_call, 1)
        seconds = (self.counted_bytes_per_call / n / self.bandwidth_bytes_per_s
                   + self.host_bytes_per_call / n / host_bw)
        return 1.0 / max(seconds, 1e-30)

    @property
    def bound_preds_per_s(self) -> float:
        if self.host_bandwidth_bytes_per_s is None:
            return (self.bandwidth_bytes_per_s
                    / max(self.bytes_per_prediction, 1e-12))
        return self._bound(self.host_bandwidth_bytes_per_s)

    @property
    def fraction_of_bound(self) -> float:
        return self.measured_preds_per_s / max(self.bound_preds_per_s, 1e-12)

    @property
    def aggregate_bound_preds_per_s(self) -> Optional[float]:
        if self.aggregate_bandwidth_bytes_per_s is None:
            return None
        if self.host_bandwidth_bytes_per_s is None:
            return (self.aggregate_bandwidth_bytes_per_s
                    / max(self.bytes_per_prediction, 1e-12))
        return self._bound(self.aggregate_bandwidth_bytes_per_s)

    @property
    def aggregate_fraction_of_bound(self) -> Optional[float]:
        bound = self.aggregate_bound_preds_per_s
        if bound is None or self.aggregate_measured_preds_per_s is None:
            return None
        return self.aggregate_measured_preds_per_s / max(bound, 1e-12)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(
            bytes_per_prediction=self.bytes_per_prediction,
            bound_preds_per_s=self.bound_preds_per_s,
            fraction_of_bound=self.fraction_of_bound,
            aggregate_bound_preds_per_s=self.aggregate_bound_preds_per_s,
            aggregate_fraction_of_bound=self.aggregate_fraction_of_bound,
        )
        return d


def serving_roofline(engine, *, rb: int, nb: int, scenario: str,
                     measured_preds_per_s: float,
                     bandwidth_bytes_per_s: Optional[float] = None,
                     host_bandwidth_bytes_per_s: Optional[float] = None
                     ) -> ServingRoofline:
    """A :class:`ServingRoofline` of a live engine: runs its deployed
    candidate forward at the (rb, nb) bucket once under
    ``op_analysis.Counter`` (the hand kernels book their work) for the
    per-call FLOPs and bytes, and adds the host pre-gather's bytes. Raises
    if the forward dispatched nothing to count.

    Bandwidths not given are measured: on a CPU engine one,
    :func:`measure_cpu_bandwidth`; on the card the device copy's
    (:func:`measure_device_bandwidth`) for the forward and the host's for
    the pre-gather."""
    from repro_torch.launch import op_analysis

    fn, args = engine.lower_candidates_forward(rb, nb)
    with torch.no_grad(), op_analysis.Counter() as counter:
        fn(*args)
    if counter.n_ops == 0 and not counter.kernels:
        raise RuntimeError("the engine's forward dispatched nothing to count")
    on_card = engine.device.type == "cuda"
    if bandwidth_bytes_per_s is None:
        bandwidth_bytes_per_s = (measure_device_bandwidth(engine.device)
                                 if on_card else measure_cpu_bandwidth())
    if on_card and host_bandwidth_bytes_per_s is None:
        host_bandwidth_bytes_per_s = measure_cpu_bandwidth()
    return ServingRoofline(
        scenario=scenario,
        predictions_per_call=rb * nb,
        counted_bytes_per_call=float(counter.bytes),
        host_bytes_per_call=float(engine.host_gather_bytes(rb, nb)),
        counted_flops_per_call=float(counter.flops),
        measured_preds_per_s=float(measured_preds_per_s),
        bandwidth_bytes_per_s=float(bandwidth_bytes_per_s),
        host_bandwidth_bytes_per_s=(
            None if host_bandwidth_bytes_per_s is None
            else float(host_bandwidth_bytes_per_s)),
    )


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
