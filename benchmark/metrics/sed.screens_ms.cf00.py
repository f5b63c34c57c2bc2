"""sed.screens_ms.cf00: device milliseconds per batch of the kernels
launched inside `BatchSEDSimulator._screens` (the dust screens' per-row
inputs of K1: τ_V and the birth cloud's τ_BC), from the profiler's kernels
attributed to the harness's span by their launch. A program without the
method leaves the metric out."""

SPANS = {"sed._screens": "synference_tpu_torch.sed:BatchSEDSimulator._screens"}


def read(trace):
    calls = trace.spans.get("sed._screens")
    device_s = trace.span_device_s.get("sed._screens")
    if not calls or device_s is None:
        return None
    return 1e3 * device_s / len(calls)
