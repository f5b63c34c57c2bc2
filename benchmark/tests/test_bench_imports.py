"""No module that a run loads has `jax`, `jaxlib`, `flax` or the JAX
package as its whole top-level name, and the references import nothing of
the program under test."""

import ast
import subprocess
import sys

import _tiny
from _tiny import harness

BENCH = harness.BENCH


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        found = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not found, (path, found)


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "synference_tpu_torch" not in set(_imports(path)), path
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.forward, benchmark.reference.nsf; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('synference')))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_a_run_loads_no_jax():
    """A whole small run in a fresh process, then the loaded modules'
    top-level names."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import _tiny\n"
        "wl, cfg = _tiny.generate_cell()\n"
        "_tiny.run('north-star.generate', wl, cfg, seconds=0.2)\n"
        "from benchmark import harness\n"
        "print(harness.forbidden_modules())\n"
        % (str(harness.ROOT), str(BENCH / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
