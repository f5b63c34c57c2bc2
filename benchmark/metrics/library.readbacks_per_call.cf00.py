"""library.readbacks_per_call.cf00: `library.readbacks_per_call` read in the
cf00 cell, where K1 runs the birth-cloud screen too (the reader is the
same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "library.readbacks_per_call")
read = _BASE.read
