"""Finds everything a cell needs by the names in ``BENCHMARK.json``: the
configuration (``configs/<config>.json``), the traffic mix
(``traffic/<traffic>.json``), the loop that drives it
(``loops/<the mix's loop>.py``), the limits of its comparison
(``limits/<cell>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``). A new cell, configuration, mix or metric is a
new file and a new entry; no file here changes for it.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path = BENCH

    @property
    def loop(self) -> str:
        return self.mix["loop"]


def _load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """Import one file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(benchmark: Path, name: str, root: Path = BENCH) -> Cell:
    """The cell ``name`` of the benchmark file ``benchmark``, its files read
    from ``root`` (``port_bench/``)."""
    spec = _load_json(benchmark)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    w = cells[name]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(root / "configs" / f"{w['config']}.json"),
        mix=_load_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(root / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer, root=root)


def loop_module(cell: Cell):
    return load_module(cell.root / "loops" / f"{cell.loop}.py",
                       f"port_bench_loop_{cell.loop}")


def metric_reader(cell: Cell, metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    mod = load_module(cell.root / "metrics" / f"{metric}.py",
                      "port_bench_metric_" + metric.replace(".", "_"))
    return mod.read


def limit(cell: Cell, number: str) -> Optional[float]:
    ent = cell.limits.get(number)
    return None if ent is None else float(ent["limit"])
