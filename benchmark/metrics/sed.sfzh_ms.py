"""sed.sfzh_ms: device milliseconds per batch of the kernels launched
inside `BatchSEDSimulator._sfzh` (SFH, metallicity and mass weights), from
the profiler's kernels attributed to the harness's span by their launch."""

SPANS = {"sed._sfzh": "synference_tpu_torch.sed:BatchSEDSimulator._sfzh"}


def read(trace):
    calls = trace.spans.get("sed._sfzh")
    device_s = trace.span_device_s.get("sed._sfzh")
    if not calls or device_s is None:
        return None
    return 1e3 * device_s / len(calls)
