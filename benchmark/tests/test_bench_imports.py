"""Nothing the harness runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: `dl4ss_tpu_torch` begins with `dl4ss_tpu` and is not it."""

from __future__ import annotations

import ast
from pathlib import Path

from conftest import run_tiny

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "dl4ss_tpu"}


def _top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_under_the_benchmark():
    for path in BENCH.rglob("*.py"):
        assert not _top_imports(path) & JAX, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = _top_imports(path)
        assert "dl4ss_tpu_torch" not in names, path
        assert names <= {"__future__", "math", "itertools", "typing",
                         "torch", "numpy", "benchmark"}, (path, names)


def test_whole_name_comparison():
    import sys
    from benchmark.harness.device import forbidden_modules
    sys.modules["dl4ss_tpu_torch_probe"] = sys
    try:
        assert "dl4ss_tpu_torch_probe" not in forbidden_modules()
    finally:
        del sys.modules["dl4ss_tpu_torch_probe"]


def test_a_run_loads_no_jax():
    import sys
    from benchmark.harness.device import forbidden_modules
    run_tiny("tdaa.serve_select_b16")
    assert "dl4ss_tpu_torch" in sys.modules
    assert forbidden_modules() == []
