"""Nothing the benchmark runs loads the JAX side: the whole-name check, the
benchmark's own sources, and the reference's independence."""

import ast
import subprocess
import sys

from conftest import ROOT
from perfbench.core.imports import forbidden_modules


def test_whole_names():
    assert forbidden_modules(["airwave_tpu_torch", "airwave_tpu_torch.ops",
                              "torch", "numpy"]) == []
    assert forbidden_modules(["airwave_tpu", "airwave_tpu.ops.upols"]) == [
        "airwave_tpu"]
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib"]
    assert forbidden_modules(["jaxtyping", "bench_utils", "chip_smoke"]) == [
        "chip_smoke"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_nothing_of_the_jax_side():
    for path in sorted((ROOT / "perfbench").rglob("*.py")):
        assert forbidden_modules(_imports(path)) == [], path


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "perfbench" / "reference").rglob("*.py")):
        assert set(_imports(path)) <= {"__future__", "math", "numpy",
                                       "torch"}, path


def test_a_run_loads_nothing_of_the_jax_side(tmp_path):
    """A tiny run on the CPU in a fresh process, then the check."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'perfbench' / 'tests')!r}]
from pathlib import Path
from conftest import make_tiny
from perfbench.core.spec import Spec
from perfbench.core.cell import run_cell
from perfbench.core.imports import forbidden_modules
root = Path({str(tmp_path)!r})
spec = Spec(root, make_tiny(root))
run_cell(spec, "ring.eq.b8192", 3, 0.05, True, "cpu")
assert "airwave_tpu_torch" in sys.modules
print(forbidden_modules(sys.modules))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
