"""spectra_mfu.prism: the operations the window's spectroscopic generate
calls need (`spectra_work.py`: both contractions, the LSF and the band
integrals over their needed columns, per real row) over the window's wall
time at the H100's fp32 peak, in percent."""

from benchmark.workcount import PEAKS


def read(trace):
    ops = trace.work.get("ops")
    if not ops:
        return None
    return 100.0 * ops / (trace.window_s * PEAKS["fp32_flops"])
