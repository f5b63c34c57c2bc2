"""sed.sfzh_ms.pacman: `sed.sfzh_ms` read in the pacman cell, where K1 runs
the escape fraction's two tables (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "sed.sfzh_ms")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
