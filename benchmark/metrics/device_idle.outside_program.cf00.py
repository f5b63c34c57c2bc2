"""device_idle.outside_program.cf00: `device_idle.outside_program` read in the
cf00 cell, where K1 runs the birth-cloud screen too (the reader is the
same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "device_idle.outside_program")
read = _BASE.read
