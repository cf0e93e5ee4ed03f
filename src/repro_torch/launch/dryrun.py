"""Multi-pod dry run: count every (arch x input shape) step of the port at
the production mesh (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape long_500k [--multi-pod] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

``--no-remat`` counts the steps with ``remat=False`` in place of each
config's own (every full config sets ``remat``), to read what remat saves.

Each combination runs rank 0's step on the meta device in a fake 256- (or
512-, ``--multi-pod``) rank world that ``dryrun_lib.run_one`` opens itself:
no environment variable, no card and no memory are needed. One summary
line per combination; exit code 1 if any failed.
"""
from __future__ import annotations

import argparse
import sys
import traceback

from repro_torch.common.config import INPUT_SHAPES
from repro_torch.launch import dryrun_lib
from repro_torch.models.registry import ARCH_IDS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="multi-pod dry run: count each rank's step on meta")
    ap.add_argument("--arch", choices=ARCH_IDS, help="architecture id")
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES), help="input shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512-rank) mesh")
    ap.add_argument("--all", action="store_true",
                    help="run every supported combo")
    ap.add_argument("--no-remat", action="store_true",
                    help="count the steps with remat=False")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --all)")
        combos = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in combos:
        try:
            res = dryrun_lib.run_one(
                arch, shape, multi_pod=args.multi_pod, out_dir=args.out,
                overrides={"remat": False} if args.no_remat else None)
            print(dryrun_lib.summarize(res), flush=True)
            if res.get("status") not in ("ok", "skipped"):
                failures += 1
        except Exception:
            failures += 1
            print(f"{arch} {shape} FAILED:\n{traceback.format_exc()}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
