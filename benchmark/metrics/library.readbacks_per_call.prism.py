"""library.readbacks_per_call.prism: `library.readbacks_per_call` read in the
nirspec-prism cell, where the spectra path runs, with no K1, z sort or plan
(the reader is the same)."""

from benchmark import harness

_BASE = harness.load_module("metrics", "library.readbacks_per_call")
read = _BASE.read
