"""library.readbacks_per_call: blocking reads of the card per `generate`
call: the program's `readback.<site>` spans (the run plan's reads, each
wait for a copy-out landing) over its `library.generate` spans in the
window (`harness.Trace.program_spans`); nothing on a trace without
them."""


def read(trace):
    spans = getattr(trace, "program_spans", None) or {}
    calls = len(spans.get("library.generate", ()))
    if not calls:
        return None
    return sum(len(iv) for name, iv in spans.items()
               if name.startswith("readback.")) / calls
