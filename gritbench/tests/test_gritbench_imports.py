"""No module of the benchmark imports the JAX stack or the JAX package, and
the reference imports nothing of the program.  Top-level names are compared
whole: ``grit_tpu_torch`` begins with ``grit_tpu`` and is not it."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from gritbench import harness

FILES = sorted(p for p in harness.ROOT.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((harness.ROOT / "reference").glob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(harness.BANNED)


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert top_level_imports(path) <= {"__future__", "math", "torch", "scipy", "gritbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("gritbench"):
            assert node.module.startswith("gritbench.reference")


def test_banned_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "grit_tpu_torch_x", sys)
    assert "grit_tpu" not in harness.banned_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.banned_loaded()


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process leaves no banned module behind."""
    code = ("import sys; from gritbench.tests.tiny import caption_cell; "
            "from gritbench import harness; c = caption_cell(); c.driver.run(c); "
            "print('BANNED', harness.banned_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BANNED []" in out.stdout
