"""Nothing the benchmark runs imports JAX, the JAX package or its
benchmarks, compared by whole top-level name; the references import
nothing of the port either."""
import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_and_no_reference_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")) + [
    PB / "yardstick" / f for f in ("compare.py", "cost.py", "peaks.py",
                                   "flops.py")],
    ids=lambda p: str(p.relative_to(PB)))
def test_yardstick_and_reference_import_nothing_of_the_port(path):
    assert "repro_torch" not in set(top_level_imports(path))


def test_the_port_is_imported_in_one_place():
    users = [p.relative_to(PB) for p in FILES
             if "repro_torch" in p.read_text()
             and "import" in p.read_text()]
    for p in users:
        assert p.parts[0] in ("program.py", "faults.py", "drivers",
                              "tools"), p
