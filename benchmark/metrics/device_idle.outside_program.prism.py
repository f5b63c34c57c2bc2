"""device_idle.outside_program.prism: `device_idle.outside_program` read in
the nirspec-prism cell, where the spectra path runs, with no K1, z sort or
plan (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "device_idle.outside_program")
read = _BASE.read
