"""k1_roofline.cf00: `k1_roofline` read in the cf00 cell, where K1 runs the
birth-cloud screen too (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "k1_roofline")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
