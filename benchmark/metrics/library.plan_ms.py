"""library.plan_ms: host milliseconds per `generate` call in
`LibraryGenerator._draw_sorted` (θ draw, z sort, padding, the run's window
plan with its one readback), from the harness's span around it."""

SPANS = {"library._draw_sorted":
         "synference_tpu_torch.library:LibraryGenerator._draw_sorted"}


def read(trace):
    times = trace.spans.get("library._draw_sorted")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
