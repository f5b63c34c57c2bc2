"""library.readbacks_per_call: blocking reads of the card per `generate`
call: the program's `readback.<site>` spans over its `library.generate`
spans in the window (`ProgramTrace.program_spans`,
`benchmark/program_trace.py`); nothing on a trace without them."""


def read(trace):
    spans = getattr(trace, "program_spans", None) or {}
    calls = len(spans.get("library.generate", ()))
    if not calls:
        return None
    return sum(len(iv) for name, iv in spans.items()
               if name.startswith("readback.")) / calls
