"""k1_roofline.paper63: `k1_roofline` read in the paper63 cell, where it
moves `library_seds_per_s.paper63` (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "k1_roofline")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
