"""k1_roofline: the least time the window's K1 launches need for the work
their rows need (`workcount.launch_work`: L_row columns per row at its
redshift, the grid columns covered read once), over K1's device time in the
trace, in percent. K1 is `k1_fused_window_kernel` or its cluster form."""


def read(trace):
    k1_s = trace.kernel_s("k1_fused_window")
    least = trace.work.get("least_s")
    if not k1_s or not least:
        return None
    return 100.0 * least / k1_s
