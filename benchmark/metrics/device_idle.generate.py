"""device_idle.generate: the share of the window in which no operation
ran on the device (1 − the union of the traced operations' intervals over
the window), in percent."""


def read(trace):
    if trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
