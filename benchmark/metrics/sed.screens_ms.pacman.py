"""sed.screens_ms.pacman: device milliseconds per batch of the kernels
launched inside `BatchSEDSimulator._screens` (the per-row inputs of K1
under Pacman emission: τ_V and the escape fraction), read as
`sed.screens_ms.cf00` reads them. A program that does not call the method
on this model leaves the metric out."""

from benchmark import harness

_BASE = harness.load_module("metrics", "sed.screens_ms.cf00")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
