"""device_idle.outside_program.pacman: `device_idle.outside_program` read in
the pacman cell, where K1 runs the escape fraction's two tables (the reader
is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "device_idle.outside_program")
read = _BASE.read
