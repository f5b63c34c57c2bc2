"""library.to_host_ms.pacman: `library.to_host_ms` read in the pacman cell,
where K1 runs the escape fraction's two tables (the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "library.to_host_ms")
read = _BASE.read
