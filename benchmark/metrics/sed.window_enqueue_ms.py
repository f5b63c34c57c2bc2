"""sed.window_enqueue_ms: host milliseconds per batch in the program's
`sed.window_body` spans (`BatchSEDSimulator._zsorted_run_raw`: the window
inputs with `_sfzh`, the window starts' copy to the card and K1's
enqueue), from `ProgramTrace.program_spans`
(`benchmark/program_trace.py`); nothing on a trace without them."""


def read(trace):
    spans = getattr(trace, "program_spans", None) or {}
    bodies = spans.get("sed.window_body")
    if not bodies:
        return None
    return 1e3 * sum(b - a for a, b in bodies) / len(bodies)
