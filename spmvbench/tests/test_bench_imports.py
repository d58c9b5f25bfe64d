"""Nothing under ``spmvbench/`` imports JAX or the JAX package, by whole
top-level module names (``repro_torch`` begins with ``repro``), and a run
refuses to report with one loaded."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from spmvbench import run

HERE = Path(run.__file__).resolve().parent


def imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not imported_top_levels(path) & set(run.FORBIDDEN)


def test_whole_names_compared(monkeypatch):
    import repro_torch  # noqa: F401

    assert "repro_torch" in sys.modules and "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run.forbidden_modules() == ["repro"]


@pytest.mark.parametrize("name", ["reference.py", "counts.py", "gen.py"]
                         + sorted(f"generators/{p.name}" for p in HERE.glob("generators/*.py")))
def test_reference_imports_nothing_of_the_program(name):
    assert "repro_torch" not in imported_top_levels(HERE / name)
