"""The JAX package's invariant linter over the port (checked on the CPU).

``repro.analysis.lint`` reads the ``# guarded-by:`` / ``# requires-lock:``
annotations and the lock order by name, so it applies to ``src/repro_torch``
as written: the port must lint clean, and the linter must see the port's
annotations (a copy of ``train/hogwild.py`` without ``HogwildStats.
merge_batch``'s ``# requires-lock: lock`` is flagged).
"""
from pathlib import Path

from repro.analysis.lint import run_lint

SRC = Path(__file__).resolve().parents[1] / "src"
HOGWILD = SRC / "repro_torch" / "train" / "hogwild.py"


def test_port_lints_clean():
    violations = run_lint([SRC / "repro_torch"], root=SRC)
    assert violations == [], "\n".join(map(str, violations))


def test_lint_sees_the_hogwild_stats_lock(tmp_path):
    text = HOGWILD.read_text()
    assert text.count("  # requires-lock: lock") == 1
    pkg = tmp_path / "repro_torch" / "train"
    pkg.mkdir(parents=True)
    (pkg / "hogwild.py").write_text(text.replace("  # requires-lock: lock", ""))
    violations = run_lint([tmp_path / "repro_torch"], root=tmp_path)
    flagged = {v.message.split()[2] for v in violations
               if v.rule == "guarded-by"}
    assert {"HogwildStats.examples", "HogwildStats.col_alive"} <= flagged
