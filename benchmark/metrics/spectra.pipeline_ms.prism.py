"""spectra.pipeline_ms.prism: device milliseconds per batch of the kernels
launched inside `SpectralFeaturePipeline.__call__` (the LSF convolution,
the resampling onto the instrument grid, the normalisation), from the
profiler's kernels attributed to the harness's span by their launch."""

SPANS = {"spectra.pipeline":
         "synference_tpu_torch.spectra:SpectralFeaturePipeline.__call__"}


def read(trace):
    calls = trace.spans.get("spectra.pipeline")
    device_s = trace.span_device_s.get("spectra.pipeline")
    if not calls or device_s is None:
        return None
    return 1e3 * device_s / len(calls)
