"""The harness finds a cell by its files alone, and BENCHMARK.json keeps to
the benchmark's contract."""
from __future__ import annotations

import json
import re
import shutil

import pytest

import pb_tiny
from benchlib import runner, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((pb_tiny.ROOT / "BENCHMARK.json").read_text())


def test_cell_added_as_files_only_is_found(tmp_path):
    """A copy of the benchmark folder gains a configuration, a traffic mix,
    a limits file and a BENCHMARK.json entry, and no file changes: the
    harness finds and runs the new cell."""
    root = tmp_path / "port_bench"
    shutil.copytree(pb_tiny.BENCH, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "ffm-50m.json").read_text())
    cfg.update(name="ffm-small", hash_space=4096)
    (root / "configs" / "ffm-small.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "serve-fused.json").read_text())
    mix.update(pool_calls=40, warmup_calls=4, requests_per_call=6,
               candidates={"lo": 3, "hi": 20},
               values_per_field=[min(v, 300) for v in mix["values_per_field"]])
    (root / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    (root / "limits" / "ffm-small.tiny-mix.json").write_text(
        json.dumps({"logit_gap": {"limit": 1e-4}}))
    b = json.loads((pb_tiny.ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "ffm-small.tiny-mix",
                           "config": "ffm-small", "traffic": "tiny-mix",
                           "chips": 1, "why": "a cell added as files"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and "ffm-50m.serve-fused" in m["workloads"]:
            m["workloads"].append("ffm-small.tiny-mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell(tmp_path / "BENCHMARK.json", "ffm-small.tiny-mix",
                          root=root)
    assert cell.config["hash_space"] == 4096 and cell.loop == "serve"
    assert {m["name"] for m in cell.end_to_end} == {"request_p95_ms",
                                                     "setup_s"}
    out = runner.run_cell(cell, pb_tiny.SEED, 0.5, False, device="cpu")
    assert out["correct"], out
    assert set(out["metrics"]) == {"request_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", pb_tiny.CELLS)
def test_every_cell_finds_its_files(cell):
    c = spec.load_cell(pb_tiny.ROOT / "BENCHMARK.json", cell)
    assert spec.loop_module(c).Loop
    for m in c.per_layer:
        assert callable(spec.metric_reader(c, m["name"]))
    assert c.limits and all("limit" in v for v in c.limits.values())
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
        assert (pb_tiny.ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in (bench["configs"] + bench["workloads"] + bench["end_to_end"]
              + bench["per_layer"]):
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        if "unit" in m:
            assert UNIT.match(m["unit"])
        for key in ("why", "layer", "source"):
            if key in m:
                assert 1 <= len(m[key]) <= 200 and "\n" not in m[key]
    assert len(json.dumps(bench)) < 64 * 1024
