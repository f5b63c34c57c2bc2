"""train.launches_per_step: device operations in the traced window over
the optimiser steps finished in it (the validation passes' operations
included): what the host has to launch per step."""


def read(trace):
    steps = trace.counters.get("steps")
    if not steps or not trace.kernels:
        return None
    return len(trace.kernels) / steps
