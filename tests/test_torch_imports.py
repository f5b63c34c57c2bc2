"""The port stands alone: importing `synference_tpu_torch` and every one of
its modules pulls in neither `jax` nor the JAX package, and starts no build.
Checked in a fresh interpreter (this test process imports both packages),
which imports the modules one after another and records what each added.
The scripts that drive the port (`chip_smoke.py`, `profile_torch.py`,
`examples/north_star_torch.py`, `examples/quickstart_torch.py`,
`scripts/probe_torch_*.py`) need a card, so their import statements are
read from their source instead. The optional packages (h5py,
scikit-learn, pandas, scipy) are imported only where they are used."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = ["synference_tpu_torch"] + sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / "synference_tpu_torch").rglob("*.py")
    if p.name != "__init__.py")

_PROBE = """
import importlib, json, sys
def banned():
    return sorted(m for m in sys.modules if m in ("jax", "jaxlib", "optax",
                  "synference_tpu") or m.startswith(("jax.", "jaxlib.",
                  "optax.", "synference_tpu.")))
out = {}
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
    out[name] = banned()
from synference_tpu_torch.ops import _cuda
out["_built"] = _cuda.load_library.cache_info().currsize
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(MODULES)], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_no_jax_in_sys_modules(probe, module):
    assert probe[module] == [], probe[module]


def test_import_builds_nothing(probe):
    assert probe["_built"] == 0


_NO_OPTIONAL = """
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("h5py", "sklearn", "pandas", "scipy"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
import importlib
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
print("ok")
"""


def test_imports_without_optional_packages():
    """h5py, scikit-learn, pandas and scipy are imported where they are
    used: the card machine has no h5py and no scikit-learn."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_OPTIONAL, json.dumps(MODULES)], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


SCRIPTS = ["chip_smoke.py", "profile_torch.py",
           "examples/north_star_torch.py",
           "examples/quickstart_torch.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob(
        "probe_torch_*.py"))


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_import_no_jax(script):
    tree = ast.parse((ROOT / script).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    banned = [n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "optax", "synference_tpu")]
    assert banned == [], banned
