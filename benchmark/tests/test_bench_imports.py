"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program; top-level names compared whole."""

from __future__ import annotations

import ast

import pytest

from benchmark.harness import FORBIDDEN
from benchmark.tests.conftest import ROOT

FILES = sorted((ROOT / "benchmark").rglob("*.py"))


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imported(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert imported(path) <= {"__future__", "contextlib", "math", "typing", "numpy", "torch", "benchmark"}


def test_whole_names_compared():
    # The port's name begins with the JAX package's; a prefix test would flag it.
    from benchmark import harness

    assert "zeronotesamba_torch" not in harness.FORBIDDEN
    assert not {"zeronotesamba_torch"} & set(FORBIDDEN)
