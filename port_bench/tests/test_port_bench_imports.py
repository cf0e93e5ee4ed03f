"""The run's check for JAX compares whole top-level names, and the plain
reference imports nothing of the program."""
from __future__ import annotations

import ast
import importlib.util

import pytest

import pb_tiny


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "port_bench_run", pb_tiny.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.serving.engine", "torch", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.ffm"], ["repro"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "reprocess", "flax_like", "benchlib"], []),
])
def test_whole_name_check(names, found):
    assert _run_module().forbidden_modules(names) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    files = sorted((pb_tiny.BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        assert set(_imports(f)) <= {"__future__", "contextlib", "typing",
                                    "numpy", "torch"}, f


def test_harness_imports_no_jax():
    for f in sorted(pb_tiny.BENCH.rglob("*.py")):
        if "tests" in f.parts:
            continue
        bad = {"jax", "jaxlib", "flax", "repro"} & set(_imports(f))
        assert not bad, (f, bad)


def test_benchmark_imports_leave_jax_unloaded():
    import subprocess
    import sys

    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import benchlib.runner, benchlib.traffic, benchlib.wire; "
            "from reference import deepffm_ref; "
            "import repro_torch.serving.engine, repro_torch.train.pipeline; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro'}))"
            % (str(pb_tiny.BENCH), str(pb_tiny.ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
