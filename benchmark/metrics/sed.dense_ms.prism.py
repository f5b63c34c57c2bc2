"""sed.dense_ms.prism: device milliseconds per batch of the kernels launched
inside `BatchSEDSimulator._core` on the spectra path (the SFZH, both
full-grid contractions, the dust screen, the IGM and the distance scale),
from the profiler's kernels attributed to the harness's span by their
launch."""

SPANS = {"sed._core": "synference_tpu_torch.sed:BatchSEDSimulator._core"}


def read(trace):
    calls = trace.spans.get("sed._core")
    device_s = trace.span_device_s.get("sed._core")
    if not calls or device_s is None:
        return None
    return 1e3 * device_s / len(calls)
