"""The program's spans in a traced window, as `harness.Trace` reads them:
the program-span readers and their twins on a synthetic trace, and nothing
from them without program spans; `harness.Trace` on a profiler's events,
by hand, with the accepted readers reading the same values on events with
and without program spans; a harness span with a program span nested in
it; the five cells' listing of the program-span metrics; and a traced CPU
run of the small generate cell."""

from types import SimpleNamespace

import pytest
import torch

import _tiny
from _tiny import harness

# the program-span readers, their units, and the twins' suffixes by cell
# (the spectra cell runs no `sed.window_body`)
PROGRAM = {"library.readbacks_per_call": "count", "library.to_host_ms": "ms",
           "sed.window_enqueue_ms": "ms", "device_idle.outside_program": "%"}
SUFFIX = {"north-star.generate": "", "paper63.generate": ".paper63",
          "cf00.generate": ".cf00", "pacman.generate": ".pacman",
          "nirspec-prism.generate": ".prism"}
READERS = tuple(n + s for s in SUFFIX.values() for n in PROGRAM
                if not (s == ".prism" and n == "sed.window_enqueue_ms"))
# per-layer metrics that read the harness's spans and the device trace
EXISTING = ("library.plan_ms", "library.plan_ms.paper63", "sed.sfzh_ms",
            "sed.sfzh_ms.paper63", "sed.sfzh_ms.pacman", "k1_roofline",
            "k1_roofline.paper63", "generate_mfu", "generate_mfu.paper63",
            "device_idle.generate", "device_idle.paper63")
MS = 1_000_000  # ns


def _read(name, trace):
    return harness.load_module("metrics", name).read(trace)


def test_program_readers_on_a_synthetic_trace():
    t = SimpleNamespace(
        window_s=2.0, busy_s=1.5, idle_outside_program_s=0.1,
        program_spans={
            "library.generate": [(0.0, 0.9), (1.0, 1.9)],
            "readback.plan_span": [(0.1, 0.2)] * 5,
            "readback.part": [(0.8, 0.85), (1.8, 1.85)],
            "library.to_host": [(0.7, 0.75), (1.7, 1.73)],
            "sed.window_body": [(0.2, 0.202), (0.3, 0.304)]})
    for name in READERS:
        base = name.rsplit(".", 1)[0] if name not in PROGRAM else name
        want = {"library.readbacks_per_call": 3.5, "library.to_host_ms": 40.0,
                "sed.window_enqueue_ms": 3.0,
                "device_idle.outside_program": 5.0}[base]
        assert abs(_read(name, t) - want) < 1e-9, name


def test_program_readers_find_nothing_without_program_spans():
    base = SimpleNamespace(window_s=2.0, busy_s=1.5, spans={},
                           span_device_s={}, kernels=[], work={},
                           counters={})
    empty = SimpleNamespace(window_s=2.0, busy_s=1.5, program_spans={},
                            idle_outside_program_s=0.0)
    for name in READERS:
        assert _read(name, base) is None, name
        assert _read(name, empty) is None, name


class _Event:
    def __init__(self, name, t0, t1, cuda=False, corr=0, linked=0):
        self._v = (name, int(t0 * MS), int((t1 - t0) * MS), corr, linked)
        self._cuda = cuda

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]


def _events(program: bool) -> list:
    """One traced 100 ms window (times in ms): a generate call at 5-95
    with one batch; harness spans around `_draw_sorted` and `_sfzh`, each
    also on the device's timeline as the profiler puts a record_function
    range there; three device operations and one blocking sync."""
    ev = [_Event("bench::window", 0, 100, corr=1),
          _Event("bench::window", 24, 70, cuda=True, corr=1),
          _Event("bench::library._draw_sorted", 5.5, 20.5, corr=2),
          _Event("bench::sed._sfzh", 23, 30, corr=3),
          _Event("bench::sed._sfzh", 24, 26, cuda=True, corr=3),
          _Event("aten::mul", 23.8, 24.1, corr=4),
          _Event("cudaLaunchKernel", 23.9, 24.0, corr=100, linked=4),
          _Event("elementwise_kernel", 24, 26, cuda=True, corr=100,
                 linked=4),
          _Event("cudaLaunchKernel", 45, 45.1, corr=101, linked=5),
          _Event("k1_fused_window_kernel", 35, 55, cuda=True, corr=101,
                 linked=5),
          _Event("cudaMemcpyAsync", 62.2, 62.4, corr=102, linked=6),
          _Event("Memcpy DtoH (Device -> Pinned)", 62.5, 70, cuda=True,
                 corr=102, linked=6),
          _Event("cudaEventSynchronize", 70, 70.1, corr=103, linked=6)]
    if program:
        ev += [_Event("synference::" + n, a, b, corr=c) for c, (n, a, b) in
               enumerate([("library.generate", 5, 95),
                          ("library.draw_sorted", 6, 20),
                          ("readback.plan_span", 15, 19),
                          ("library.batch", 21, 60),
                          ("sed.window_body", 22, 50),
                          ("sed.sfzh", 23.5, 29.5),
                          ("library.stage", 52, 58),
                          ("library.to_host", 61, 94),
                          ("readback.part", 62, 80)], start=10)]
    return ev


def _run(events: list):
    t_begin = 1000.0
    run = SimpleNamespace(
        window_s=0.1, counters={}, t_begin=t_begin, t_end=t_begin + 0.1,
        work={"least_s": 0.01, "ops": 6.7e10},
        prof=SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events))))
    spans = SimpleNamespace(times={
        "library._draw_sorted": [(t_begin + 0.0055, t_begin + 0.0205)],
        "sed._sfzh": [(t_begin + 0.023, t_begin + 0.030)]})
    return run, spans


def _trace(program: bool):
    return harness.Trace(*_run(_events(program)))


def test_existing_readers_read_the_same_beside_program_spans():
    plain = _trace(program=False)
    t = _trace(program=True)
    values = {n: _read(n, plain) for n in EXISTING}
    assert None not in values.values(), values
    assert {n: _read(n, t) for n in EXISTING} == values
    assert t.busy_s == plain.busy_s and t.kernels == plain.kernels
    assert t.span_device_s == plain.span_device_s
    assert t.spans == plain.spans
    assert plain.program_spans == {} and plain.host_syncs == {
        "outside any span": 1}


def test_trace_by_hand():
    t = _trace(program=True)
    ms = 1e-3
    assert t.program_spans["library.generate"] == [(5 * ms, 95 * ms)]
    assert len(t.program_spans) == 9
    assert abs(t.busy_s - 29.5 * ms) < 1e-12
    want_device = {"library.generate": 29.5, "library.batch": 22.0,
                   "sed.window_body": 22.0, "sed.sfzh": 2.0,
                   "library.to_host": 7.5, "readback.part": 7.5}
    assert set(t.program_device_s) == set(want_device)
    for name, v in want_device.items():
        assert abs(t.program_device_s[name] - v * ms) < 1e-12, name
    want_idle = {"outside any span": 10.0, "library.generate": 3.0,
                 "library._draw_sorted": 1.0, "library.draw_sorted": 10.0,
                 "readback.plan_span": 4.0, "library.batch": 3.0,
                 "sed.window_body": 6.0, "sed._sfzh": 1.0, "sed.sfzh": 4.0,
                 "library.stage": 3.0, "library.to_host": 15.0,
                 "readback.part": 10.5}
    assert set(t.idle_by_span) == set(want_idle)
    for name, v in want_idle.items():
        assert abs(t.idle_by_span[name] - v * ms) < 1e-9, name
    assert abs(t.idle_outside_program_s - 10.0 * ms) < 1e-9
    assert t.host_syncs == {"readback.part": 1}
    out = t.breakdown()
    gaps = dict(out["idle_gaps"])
    assert gaps["outside any span"] == t.idle_outside_program_s
    assert out["host_syncs"] == [["readback.part", 1]]
    assert _read("library.readbacks_per_call", t) == 2.0
    assert abs(_read("library.to_host_ms", t) - 33.0) < 1e-6
    assert abs(_read("sed.window_enqueue_ms", t) - 28.0) < 1e-6
    assert abs(_read("device_idle.outside_program", t) - 10.0) < 1e-6


def test_program_span_nested_in_a_harness_span():
    """`bench::sed._sfzh` at 10-20 ms around `synference::sed.sfzh` at
    12-18, one kernel launched at 13 that runs 14-16: the kernel list, the
    busy time and the harness span's device time are what a trace that
    reads no program span reads (one kernel, 2 ms, 2 ms); the idle inside
    the program span goes to it, and the harness span keeps the idle
    between its edges and the program span's."""
    ev = [_Event("bench::window", 0, 30, corr=1),
          _Event("bench::sed._sfzh", 10, 20, corr=2),
          _Event("synference::sed.sfzh", 12, 18, corr=3),
          _Event("aten::exp", 12.9, 13.2, corr=4),
          _Event("cudaLaunchKernel", 13, 13.1, corr=100, linked=4),
          _Event("exp_kernel", 14, 16, cuda=True, corr=100, linked=4)]
    run, spans = _run(ev)
    run.window_s = 0.03
    spans.times = {"sed._sfzh": [(run.t_begin + 0.010, run.t_begin + 0.020)]}
    t = harness.Trace(run, spans)
    ms = 1e-3
    assert t.kernels == [("exp_kernel", 14 * ms, 16 * ms)]
    assert abs(t.busy_s - 2 * ms) < 1e-12
    assert set(t.span_device_s) == {"sed._sfzh"}
    assert abs(t.span_device_s["sed._sfzh"] - 2 * ms) < 1e-12
    assert abs(t.program_device_s["sed.sfzh"] - 2 * ms) < 1e-12
    want_idle = {"outside any span": 20.0, "sed._sfzh": 4.0,
                 "sed.sfzh": 4.0}
    assert set(t.idle_by_span) == set(want_idle)
    for name, v in want_idle.items():
        assert abs(t.idle_by_span[name] - v * ms) < 1e-9, name
    assert abs(t.idle_outside_program_s - 24.0 * ms) < 1e-9
    assert abs(_read("sed.sfzh_ms", t) - 2.0) < 1e-9


def test_innermost_nests_at_shared_edges():
    pieces = harness.innermost([(0.0, 4.0, "a"), (0.0, 2.0, "b"),
                                (2.0, 4.0, "c"), (5.0, 6.0, "d")])
    assert pieces == [(0.0, 2.0, "b"), (2.0, 4.0, "c"), (5.0, 6.0, "d")]
    idle = harness.split_idle([(1.0, 5.5)], pieces)
    assert dict(idle) == {"b": 1.0, "c": 2.0, harness.OUTSIDE: 1.0,
                          "d": 0.5}


@pytest.mark.parametrize("cell", sorted(SUFFIX))
def test_every_cell_lists_its_program_span_metrics(cell):
    spec = harness.bench_spec()
    e2e, layer = harness.cell_metrics(spec, cell)
    rate = next(m["name"] for m in e2e if m["name"] != "setup_s")
    listed = {m["name"]: m for m in layer}
    for base, unit in PROGRAM.items():
        name = base + SUFFIX[cell]
        if name not in READERS:
            continue
        m = listed[name]
        assert (m["unit"], m["better"], m["moves"], m["workloads"]) == (
            unit, "lower", rate, [cell]), name


@pytest.fixture
def traced_run():
    wl, cfg = _tiny.generate_cell()
    cfg["model"]["prior"]["redshift"] = [1.0, 1.5]  # windows narrower
    spec = harness.bench_spec()
    e2e, layer = harness.cell_metrics(spec, "north-star.generate")
    import time

    return harness.run_cell(
        "north-star.generate", 2 ** 31 + 11, 0.5, True, "cpu",
        time.perf_counter(), workload=wl, config=cfg, end_to_end=e2e,
        per_layer=layer)


def test_traced_cpu_run_reads_the_program_spans(traced_run):
    result, _ = traced_run
    assert result["correct"] is True
    m = result["metrics"]
    # one batch of 4096 rows a call: the run plan's two reads (its knot
    # span, then its window starts); the copy-out's landings need no wait
    assert m["library.readbacks_per_call"]["value"] == 2.0
    assert m["library.readbacks_per_call"]["unit"] == "count"
    assert m["library.to_host_ms"]["value"] > 0.0
    assert m["sed.window_enqueue_ms"]["value"] > 0.0
    assert "library.plan_ms" in m
    # no device operations on the CPU: no idle share to read
    assert "device_idle.outside_program" not in m
    labels = {n for n, _ in result["breakdown"]["idle_gaps"]}
    assert labels & {"library.to_host", "sed.window_body", "sed.sfzh",
                     "library.draw_sorted", "library.batch"}
    assert "host_syncs" in result["breakdown"]
