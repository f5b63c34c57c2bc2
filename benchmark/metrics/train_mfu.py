"""train_mfu: the matrix-product operations the window's steps and
validation passes need (the ensemble's conditioner MLPs, forward and
backward, from the flow's widths, transforms, members and batch) over the
window's wall time at the H100's fp32 peak (TF32 is off), in percent."""

from benchmark.workcount import PEAKS


def read(trace):
    ops = trace.work.get("ops")
    if not ops:
        return None
    return 100.0 * ops / (trace.window_s * PEAKS["fp32_flops"])
