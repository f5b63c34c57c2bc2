"""device_idle.pacman: `device_idle.generate` read in the pacman cell (the
reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "device_idle.generate")
read = _BASE.read
