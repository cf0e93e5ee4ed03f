#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once and prints its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, loop,
limits and per-layer metrics are found by name (``benchlib/spec.py``). The
run makes its weights and traffic from ``--seed``, warms up, measures for
``--seconds``, frees the program, compares what the window produced with
the plain reference (``reference/``), and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` (and ``breakdown`` with ``--trace 1``), and
last ``checks``: each compared number beside its limit, which also end
standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it prints
no result and exits 2; if a module of JAX or of the JAX package ``repro``
is loaded once the window has closed, it names it and exits 3.

``--control tf32|bf16`` puts the reference, computed in that precision, in
the program's place: the comparison must then come out false.
``--control half_batch`` (training cells) puts there the reference run on
half of each microbatch: a planted fault's readings.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None):
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names}
                  & set(FORBIDDEN))


def _environment() -> None:
    # kernel and build caches at fixed paths inside the checkout, so only
    # a checkout's first run builds (the program's own library lands in
    # src/repro_torch/_build/); host math on one thread each, so the
    # clients' threads are the run's only host parallelism
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    cache = ROOT / ".port_bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32", "bf16", "half_batch"))
    args = ap.parse_args(argv)

    _environment()
    sys.path.insert(0, str(HERE))
    from benchlib import spec

    cell = spec.load_cell(ROOT / "BENCHMARK.json", args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {torch.cuda.device_count()}; no result", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"port_bench: no {src}/repro_torch; no result", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from benchlib.runner import run_cell

    card = _power_limit()
    print(f"port_bench: {cell.name} seed {args.seed} on {card}",
          file=sys.stderr)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   control=args.control, t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded {found}: the run may not load JAX or the "
              "JAX package; no result", file=sys.stderr)
        return 3
    out["power_limit"] = card
    out["checks"] = out.pop("checks")  # the last key
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
