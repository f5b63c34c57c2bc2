"""k1_roofline.pacman: `k1_roofline` read in the pacman cell, where K1 runs
both first products (the escape kernels): the driver counts 4·C·L_row a
row (`drivers/pacman.py::launch_work`), and the reader is the same."""

from benchmark import harness

_BASE = harness.load_module("metrics", "k1_roofline")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
