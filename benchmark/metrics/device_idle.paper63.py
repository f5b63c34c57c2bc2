"""device_idle.paper63: `device_idle.generate` read in the paper63 cell,
where it moves `library_seds_per_s.paper63` (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "device_idle.generate")
read = _BASE.read
