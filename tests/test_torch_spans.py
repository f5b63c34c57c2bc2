"""The program's own spans (`runtime.span`, `runtime.traced`) on the
library-generation path.

With no profiler recording, a span is one flag check and a shared no-op
context: no profiler range is made. While one records, a span is a range
of the host's timeline (the trace's "cpu_op" category, the profiler's
fast record function): a `record_function` range would also put a
"gpu_user_annotation" over the kernels launched inside it on the device's
timeline, where a reader of device time would count it as device work.
Under `trace_profile`, each
`generate` call is one `synference::library.generate` range in the Chrome
trace, every other program range nests inside it, and each blocking read
of the card is one `synference::readback.<site>` range: on the device
path, two for the run's plan (its span, its window starts) and none a
batch, whatever the number of batches: each batch takes its slice of the
run's starts (`sed.plan_windows` still pads it and checks the slice, so it
opens once for the run and once a batch). Each batch's photometry and θ
rows are one
`synference::library.stage` range; on the CPU they are written in place,
so no `readback.part` waits for a copy. The returned library is bitwise
the same with the profiler on and off.
"""

import json

import numpy as np
import pytest
import torch

import synference_tpu_torch as tt
from synference_tpu_torch import runtime
from synference_tpu_torch.runtime import span, trace_profile, traced

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
# a narrow redshift range: every batch's window is narrower than the table
PRIOR = {"log10_mass": (7.5, 11.0), "redshift": (1.0, 1.3),
         "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
         "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
BATCH = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gen():
    grid = tt.make_synthetic_grid(n_ages=8, n_mets=4, n_wav=1024)
    filt = tt.FilterSet([tt.tophat_filter("F150W", 15000., 3300.),
                         tt.tophat_filter("F277W", 27700., 7000.)])
    sim = tt.BatchSEDSimulator(grid, filt, PNAMES, sfh="lognormal",
                               zdist="delta", emission=tt.EmissionConfig(),
                               device="cpu")
    return tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                               device="cpu")


def _program_ranges(log_dir) -> list:
    """(name, start, end) of the trace's `synference::` ranges, µs."""
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"][len("synference::"):], float(e["ts"]),
             float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("synference::")]


def test_no_profiler_makes_no_record_function(monkeypatch, gen):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert span("library.to_host") is span("readback.theta")
    with span("library.to_host"):
        pass
    assert traced("x")(lambda a, b=1: a + b)(2, b=3) == 5
    lib = gen.generate(n=BATCH, batch_size=BATCH, seed=1)
    assert lib["photometry"].shape == (2, BATCH)


def test_span_is_a_profiler_range_only_while_one_records(tmp_path):
    @traced("outer")
    def outer(x):
        with span("inner"):
            return x + 1

    assert outer(1) == 2
    assert outer.__name__ == "outer"
    with trace_profile(str(tmp_path)):
        assert runtime._profiling()
        assert outer(1) == 2
    assert not runtime._profiling()
    names = [n for n, _, _ in _program_ranges(tmp_path)]
    assert sorted(names) == ["inner", "outer"]
    with open(tmp_path / "trace.json") as f:
        cats = {e.get("cat") for e in json.load(f)["traceEvents"]
                if str(e.get("name", "")).startswith("synference::")}
    assert cats == {"cpu_op"}


@pytest.mark.parametrize("batches", [1, 2, 3])
def test_generate_spans_nest_and_count_readbacks(tmp_path, gen, batches):
    n = batches * BATCH - 5
    off = gen.generate(n=n, batch_size=BATCH, seed=7)
    with trace_profile(str(tmp_path)):
        on = [gen.generate(n=n, batch_size=BATCH, seed=7) for _ in range(2)]
    assert on[0]["parameters"].dtype == np.float32
    for lib in on:
        for key in ("parameters", "photometry"):
            np.testing.assert_array_equal(lib[key], off[key])

    ranges = _program_ranges(tmp_path)
    calls = sorted((a, b) for n_, a, b in ranges if n_ == "library.generate")
    assert len(calls) == 2
    assert all(b >= a for _, a, b in ranges)  # every range closed
    # ranges nest: two ranges are disjoint or one holds the other
    for _, a, b in ranges:
        for _, c, d in ranges:
            assert d <= a or b <= c or (a <= c and d <= b) or (
                c <= a and b <= d)
    per_call = []
    for a, b in calls:
        inside = [n_ for n_, c, d in ranges
                  if a <= c and d <= b and (c, d) != (a, b)]
        per_call.append(sorted(inside))
    assert per_call[0] == per_call[1]
    inside = per_call[0]
    assert len(inside) + 1 == len(ranges) // 2  # none outside a call
    readbacks = [n_ for n_ in inside if n_.startswith("readback.")]
    assert len(readbacks) == 2
    assert {r: readbacks.count(r) for r in set(readbacks)} == {
        "readback.plan_span": 1, "readback.window_starts": 1}
    assert inside.count("library.draw_sorted") == 1
    assert inside.count("library.batch") == batches
    assert inside.count("sed.window_body") == batches
    assert inside.count("sed.sfzh") == batches
    assert inside.count("sed.plan_windows") == 1 + batches
    assert inside.count("library.stage") == batches
    assert inside.count("library.to_host") == 1
    assert set(inside) == {
        "library.draw_sorted", "library.batch", "library.stage",
        "library.to_host", "sed.plan_windows", "sed.window_body",
        "sed.sfzh", "readback.plan_span", "readback.window_starts"}
