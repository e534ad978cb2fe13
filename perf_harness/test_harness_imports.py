"""No module of the harness imports JAX or the JAX package, and the plain
reference imports nothing of the program either. Module names are compared
by their whole top-level name (``repro_torch`` is the program, ``repro``
the JAX package it was ported from)."""
import ast
from pathlib import Path

import pytest

HARNESS = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HARNESS.rglob("*.py")), ids=lambda p: str(p.relative_to(HARNESS)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (HARNESS / "reference").rglob("*.py"):
        found = top_level_imports(path)
        assert "repro_torch" not in found and not found & FORBIDDEN, path
        assert found <= {"__future__", "math", "struct", "typing", "zlib", "dataclasses",
                         "numpy"}, (path, found)


def test_whole_name_comparison():
    """``repro_torch`` passes, ``repro`` and ``jax.numpy`` do not."""
    from perf_harness.run import FORBIDDEN as RUN_FORBIDDEN
    assert set(RUN_FORBIDDEN) == FORBIDDEN
    tops = {m.split(".")[0] for m in ("repro_torch.core", "jax.numpy", "repro.core")}
    assert tops & FORBIDDEN == {"jax", "repro"}
