"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference loads nothing of the program. Module names are compared by
their top-level name, whole: the port's name begins with the JAX
package's."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmarks import harness

BENCH = Path(harness.__file__).resolve().parent
PORT = "relationalgraphlearning_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_names_compare_whole():
    assert "relationalgraphlearning_tpu" in harness.FORBIDDEN
    assert PORT.split(".")[0] not in harness.FORBIDDEN
    assert PORT.startswith("relationalgraphlearning_tpu")


def test_no_file_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert PORT not in top_level_imports(path), path


def test_a_cells_modules_leave_jax_unloaded():
    """Every driver, metric and the port modules they load, in a fresh
    process: nothing of the JAX stack or the JAX package in sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {str(BENCH.parent)!r})
from benchmarks import harness, run, tracing
from benchmarks.tests import tiny
for cell in [c["name"] for c in harness.load_benchmark()["workloads"]]:
    checks, _, _ = tiny.run(cell)
    assert harness.judge(checks), checks
found = harness.forbidden_modules()
ref = [n for n in sys.modules if n.startswith("benchmarks.reference")]
print(found, len(ref))
assert not found, found
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]


def test_the_reference_alone_loads_nothing_of_the_program():
    """Every module of ``reference/``, found by its file, in a fresh
    process."""
    mods = sorted(p.stem for p in (BENCH / "reference").glob("*.py")
                  if p.stem != "__init__")
    assert {"mprl", "crowd", "scenarios", "orca"} <= set(mods)
    code = f"""
import importlib, sys
sys.path.insert(0, {str(BENCH.parent)!r})
for m in {mods!r}:
    importlib.import_module("benchmarks.reference." + m)
assert not [n for n in sys.modules if n.split(".")[0] == {PORT!r}]
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
