"""generate_mfu.cf00: `generate_mfu` read in the cf00 cell, where K1 runs the
birth-cloud screen too (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "generate_mfu")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
