"""sed.sfzh_ms.paper63: `sed.sfzh_ms` read in the paper63 cell, where it
moves `library_seds_per_s.paper63` (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "sed.sfzh_ms")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
