"""library.readbacks_per_call.pacman: `library.readbacks_per_call` read in the
pacman cell, where K1 runs the escape fraction's two tables (the reader is
the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "library.readbacks_per_call")
read = _BASE.read
