"""The benchmark imports neither JAX nor the JAX package; its references
import nothing of the program."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not {"jax", "jaxlib", "blade", "flax", "optax"} & set(_imports(path))


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    assert "blade_torch" not in set(_imports(path))
    assert "blade_torch" not in path.read_text()


def test_no_file_names_the_jax_benchmark():
    for path in ROOT.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json") and path != Path(__file__):
            text = path.read_text()
            assert "BENCH_r0" not in text and "BASELINE.json" not in text
            assert "bench.py" not in text.replace("bench_torch", "")
