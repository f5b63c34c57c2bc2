"""library.plan_ms.paper63: `library.plan_ms` read in the paper63 cell,
where it moves `library_seds_per_s.paper63` (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "library.plan_ms")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
