"""device_idle.prism: `device_idle.generate` read in the nirspec-prism cell
(the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "device_idle.generate")
read = _BASE.read
