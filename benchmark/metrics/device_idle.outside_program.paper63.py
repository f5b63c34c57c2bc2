"""device_idle.outside_program.paper63: `device_idle.outside_program` read in
the paper63 cell, where it moves `library_seds_per_s.paper63` (the reader
is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "device_idle.outside_program")
read = _BASE.read
