"""library.readbacks_per_call.paper63: `library.readbacks_per_call` read in
the paper63 cell, where it moves `library_seds_per_s.paper63` (the reader
is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "library.readbacks_per_call")
read = _BASE.read
