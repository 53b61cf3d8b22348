"""What the benchmark's files may import and read: no JAX, no JAX package,
nothing of the repository's JAX-era benchmarks; a reference that imports
nothing of the port."""

import ast
from pathlib import Path

import pytest

import perfbench_tiny as tiny
from harness import session

FILES = sorted(tiny.BENCH.rglob("*.py"))
PORT = "constructionsceneposeestimation_tpu_torch"


def imported(path: Path) -> set[str]:
    """The top-level names of every module ``path`` imports (absolute
    imports; relative ones stay inside their package)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(tiny.BENCH)))
def test_no_jax(path):
    assert not imported(path) & set(session.FORBIDDEN)


def test_top_level_names_compared_whole():
    """The port's name begins with the JAX package's: a prefix match would
    flag it."""
    assert session.forbidden_modules([PORT, f"{PORT}.render", "jaxtyping"]) == []
    assert session.forbidden_modules(["jax.numpy", "constructionsceneposeestimation_tpu.cli",
                                      "flax"]) == ["constructionsceneposeestimation_tpu.cli",
                                                    "flax", "jax.numpy"]


@pytest.mark.parametrize("path", sorted((tiny.BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(tiny.BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported(path)
    tree = ast.parse(path.read_text())
    rel = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level]
    assert "utils.kernels" not in rel and "kernels" not in rel


@pytest.mark.parametrize("path", [f for f in FILES if f.parent.name != "tests"],
                         ids=lambda p: str(p.relative_to(tiny.BENCH)))
def test_reads_no_jax_era_benchmark(path):
    text = path.read_text()
    assert "benchmarks/" not in text and "BENCH_r0" not in text
    assert not any(line.strip().startswith(("import bench", "from bench "))
                   for line in text.splitlines())
