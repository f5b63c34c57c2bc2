"""generate_mfu.paper63: `generate_mfu` read in the paper63 cell, where it
moves `library_seds_per_s.paper63` (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "generate_mfu")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
