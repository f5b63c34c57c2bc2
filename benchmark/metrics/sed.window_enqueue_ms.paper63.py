"""sed.window_enqueue_ms.paper63: `sed.window_enqueue_ms` read in the paper63
cell, where it moves `library_seds_per_s.paper63` (the reader is the
same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "sed.window_enqueue_ms")
read = _BASE.read
