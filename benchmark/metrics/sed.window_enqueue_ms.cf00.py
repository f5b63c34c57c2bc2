"""sed.window_enqueue_ms.cf00: `sed.window_enqueue_ms` read in the cf00 cell,
where K1 runs the birth-cloud screen too (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "sed.window_enqueue_ms")
read = _BASE.read
