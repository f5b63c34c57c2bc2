"""sed.window_enqueue_ms.pacman: `sed.window_enqueue_ms` read in the pacman
cell, where K1 runs the escape fraction's two tables (the reader is the
same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "sed.window_enqueue_ms")
read = _BASE.read
