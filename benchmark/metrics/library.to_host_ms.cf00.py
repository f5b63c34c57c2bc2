"""library.to_host_ms.cf00: `library.to_host_ms` read in the cf00 cell, where
K1 runs the birth-cloud screen too (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "library.to_host_ms")
read = _BASE.read
