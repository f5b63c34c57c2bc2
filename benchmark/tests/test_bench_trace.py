"""Per-layer metric readers on a synthetic trace, and the breakdown."""

from types import SimpleNamespace

import _tiny
from _tiny import harness


def _trace(**kw):
    base = dict(window_s=2.0, busy_s=1.5, counters={"steps": 10},
                work={"least_s": 0.5, "ops": 6.7e12}, spans={},
                span_device_s={},
                kernels=[("k1_fused_window_kernel", 0.0, 0.5),
                         ("k1_fused_window_kernel", 0.6, 1.1),
                         ("elementwise", 1.2, 1.7)])
    base.update(kw)
    return SimpleNamespace(kernel_s=lambda *f: sum(
        b - a for n, a, b in base["kernels"] if any(x in n for x in f)),
        **base)


def _read(name, trace):
    return harness.load_module("metrics", name).read(trace)


def test_readers_on_a_synthetic_trace():
    t = _trace(spans={"library._draw_sorted": [0.010, 0.030],
                      "sed._sfzh": [0.001] * 4},
               span_device_s={"sed._sfzh": 0.008})
    assert _read("k1_roofline", t) == 50.0
    assert abs(_read("generate_mfu", t) - 5.0) < 1e-12
    assert abs(_read("device_idle.generate", t) - 25.0) < 1e-12
    assert abs(_read("library.plan_ms", t) - 20.0) < 1e-9
    assert abs(_read("sed.sfzh_ms", t) - 2.0) < 1e-9
    assert _read("train.launches_per_step", t) == 0.3


def test_readers_find_nothing_and_return_nothing():
    t = _trace(kernels=[], busy_s=0.0, work={}, counters={})
    for name in ("k1_roofline", "generate_mfu", "device_idle.generate",
                 "library.plan_ms", "sed.sfzh_ms", "train_mfu",
                 "train.launches_per_step", "train.validation_ms",
                 "device_idle.train"):
        assert _read(name, t) is None, name


def test_spans_wrap_and_restore():
    spans = harness.Spans()
    from benchmark import workcount

    orig = workcount.band_support
    assert spans.wrap("x", "benchmark.workcount:band_support")
    assert not spans.wrap("y", "benchmark.workcount:no_such_function")
    workcount.band_support([])
    assert len(spans.times["x"]) == 1
    spans.restore()
    assert workcount.band_support is orig
