"""device_idle.outside_program: the share of the window in which the
device is idle and no program span is open, in percent: the client's own
time between `generate` calls, which the program cannot shorten
(`harness.Trace.idle_outside_program_s`); nothing on a trace without
program spans."""


def read(trace):
    spans = getattr(trace, "program_spans", None) or {}
    if trace.busy_s <= 0.0 or not spans.get("library.generate"):
        return None
    return 100.0 * trace.idle_outside_program_s / trace.window_s
