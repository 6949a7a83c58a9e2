"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port; names compared as whole top-level
module names."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "codeps_tpu"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_no_port(path):
    assert "codeps_torch" not in set(imported(path))


def test_the_check_compares_whole_names():
    from benchmark import run
    import sys
    assert "codeps_torch" not in run.FORBIDDEN
    before = set(sys.modules)
    sys.modules["codeps_tpu_like"] = sys
    try:
        assert run.loaded_forbidden() == sorted(
            {n.split(".")[0] for n in before} & FORBIDDEN)
    finally:
        del sys.modules["codeps_tpu_like"]
