"""generate_mfu: the operations the window's generate calls need
(`workcount`, counted per row at its redshift) over the window's wall time
at the H100's fp32 peak, in percent."""

from benchmark.workcount import PEAKS


def read(trace):
    ops = trace.work.get("ops")
    if not ops:
        return None
    return 100.0 * ops / (trace.window_s * PEAKS["fp32_flops"])
