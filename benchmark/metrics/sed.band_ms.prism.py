"""sed.band_ms.prism: device milliseconds per batch of the kernels launched
inside `BatchSEDSimulator._photometry_batch` (the spectra path's band
integrals: the bf16 knot product over every knot and the interpolated
ratio), from the profiler's kernels attributed to the harness's span by
their launch."""

SPANS = {"sed._photometry_batch":
         "synference_tpu_torch.sed:BatchSEDSimulator._photometry_batch"}


def read(trace):
    calls = trace.spans.get("sed._photometry_batch")
    device_s = trace.span_device_s.get("sed._photometry_batch")
    if not calls or device_s is None:
        return None
    return 1e3 * device_s / len(calls)
