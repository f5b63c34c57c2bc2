"""library.to_host_ms: host milliseconds per `generate` call in the
program's `library.to_host` spans: the end-of-call wait for the copy-out's
last landings on the host (with `resume_path`, each batch's reads and the
concatenation), from `harness.Trace.program_spans`; nothing on a trace
without them."""


def read(trace):
    spans = getattr(trace, "program_spans", None) or {}
    calls = len(spans.get("library.generate", ()))
    copies = spans.get("library.to_host")
    if not calls or not copies:
        return None
    return 1e3 * sum(b - a for a, b in copies) / calls
