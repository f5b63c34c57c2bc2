"""library.to_host_ms.paper63: `library.to_host_ms` read in the paper63 cell,
where it moves `library_seds_per_s.paper63` (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "library.to_host_ms")
read = _BASE.read
