"""device_idle.train: the share of the training window in which no
operation ran on the device, in percent."""


def read(trace):
    if trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
