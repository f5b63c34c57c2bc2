"""library.to_host_ms.prism: `library.to_host_ms` read in the nirspec-prism
cell, where the spectra path runs, with no K1, z sort or plan (the reader
is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "library.to_host_ms")
read = _BASE.read
