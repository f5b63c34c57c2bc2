"""generate_mfu.pacman: `generate_mfu` read in the pacman cell, where the
driver counts both first products a row (`drivers/pacman.py::_work`; the
reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "generate_mfu")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
