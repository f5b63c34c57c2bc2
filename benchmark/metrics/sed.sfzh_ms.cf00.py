"""sed.sfzh_ms.cf00: `sed.sfzh_ms` read in the cf00 cell, where K1 runs the
birth-cloud screen too (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "sed.sfzh_ms")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
