"""sed.window_enqueue_ms: host milliseconds per batch in the program's
`sed.window_body` spans (`BatchSEDSimulator._zsorted_run_raw`: the window
inputs with `_sfzh` and `_screens`, the batch's slice of the run's window
starts sent to the card, and K1's enqueue; no read of the card), from
`harness.Trace.program_spans`; nothing on a trace without them."""


def read(trace):
    spans = getattr(trace, "program_spans", None) or {}
    bodies = spans.get("sed.window_body")
    if not bodies:
        return None
    return 1e3 * sum(b - a for a, b in bodies) / len(bodies)
