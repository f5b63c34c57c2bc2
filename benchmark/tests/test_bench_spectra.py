"""The spectroscopic cell's files on the CPU at a small size: the driver's
run and check (the program passes, the TF32 control and both planted
faults fail `spec_gap_p99`), each new per-layer reader on a synthetic
trace, and the work count against a hand count.

The simulator takes the card's spectra route here
(`photometry_backend="pallas"`, the bf16 knot product), which the
reference follows; "auto" on the CPU takes the exact per-galaxy filter
integral instead."""

from types import SimpleNamespace

import numpy as np
import pytest

import _tiny
from _tiny import harness

CELL = "nirspec-prism.generate"


@pytest.fixture
def card_route(monkeypatch):
    from synference_tpu_torch import sed

    init = sed.BatchSEDSimulator.__init__

    def pallas_init(self, *args, **kwargs):
        kwargs["photometry_backend"] = "pallas"
        init(self, *args, **kwargs)

    monkeypatch.setattr(sed.BatchSEDSimulator, "__init__", pallas_init)


def _cell():
    wl = harness.load_json("workloads", CELL)
    cfg = harness.load_json("configs", wl["config"])
    cfg["grid"].update(n_ages=8, n_mets=4, n_wav=2048, lam_min=500.0,
                       lam_max=1.0e5)
    cfg["filters"] = cfg["filters"][::3]
    wl["params"].update(rows_per_call=300, warmup_calls=1,
                        sample_rows_per_call=16, max_sample_rows=64,
                        strata=10)
    return wl, cfg


def _over(readings: dict, limits: dict) -> list:
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


def test_spectra_cell_runs_and_is_correct(card_route):
    wl, cfg = _cell()
    result, checks = _tiny.run(CELL, wl, cfg)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"library_seds_per_s", "setup_s"}
    assert {n for n, _, _ in checks} == set(wl["limits"])


def test_spectra_control_and_faults_fail(card_route):
    wl, cfg = _cell()
    driver = harness.load_module("drivers", wl["driver"])
    ctx = _tiny.ctx(CELL, wl, cfg)
    state = driver.run(ctx).pop("state")
    assert state["spec"].shape[1] == cfg["spectra"]["features"]
    program = driver.check(ctx, state)
    assert all(v <= lim for _, v, lim in program), program
    assert "spec_gap_p99" in _over(driver.control(ctx, state), wl["limits"])
    for name, readings in driver.faults(ctx, state).items():
        assert "spec_gap_p99" in _over(readings, wl["limits"]), name


def test_traced_cpu_run_reads_the_work(card_route):
    """On the CPU the profiler sees no device kernels: of the cell's
    metrics only `spectra_mfu.prism` and the two that read the program's
    spans on the host have something to read."""
    wl, cfg = _cell()
    result, _ = _tiny.run(CELL, wl, cfg, trace=True)
    assert result["correct"]
    assert set(result["metrics"]) == {"spectra_mfu.prism",
                                      "library.readbacks_per_call.prism",
                                      "library.to_host_ms.prism"}
    assert 0.0 < result["metrics"]["spectra_mfu.prism"]["value"] < 100.0


def _trace(**kw):
    base = dict(spans={}, span_device_s={}, work={}, window_s=2.0,
                busy_s=1.5)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("metric,span", [
    ("sed.dense_ms.prism", "sed._core"),
    ("sed.band_ms.prism", "sed._photometry_batch"),
    ("spectra.pipeline_ms.prism", "spectra.pipeline")])
def test_span_readers(metric, span):
    mod = harness.load_module("metrics", metric)
    assert span in mod.SPANS
    assert mod.read(_trace()) is None
    tr = _trace(spans={span: [0.01] * 4}, span_device_s={span: 0.02})
    assert mod.read(tr) == pytest.approx(5.0)


def test_roofline_mfu_and_idle_readers():
    roof = harness.load_module("metrics", "contract_roofline.prism")
    mfu = harness.load_module("metrics", "spectra_mfu.prism")
    idle = harness.load_module("metrics", "device_idle.prism")
    assert "sed._intrinsic_lnu" in roof.SPANS
    tr = _trace(span_device_s={"sed._intrinsic_lnu": 0.5},
                work={"contract_least_s": 0.3, "ops": 6.7e12})
    assert roof.read(tr) == pytest.approx(60.0)
    assert mfu.read(tr) == pytest.approx(5.0)
    assert idle.read(tr) == pytest.approx(25.0)
    assert roof.read(_trace()) is None and mfu.read(_trace()) is None
    assert idle.read(_trace(busy_s=0.0)) is None


def test_work_count_by_hand():
    from benchmark import spectra_work

    lam = np.arange(1000.0, 2000.0, 10.0)  # 100 columns
    band = ("b", np.array([1190.0, 1200.0, 1300.0, 1310.0]),
            np.array([0.0, 1.0, 1.0, 0.0]))
    z = np.array([0.0, 1.0])
    # the band's support (T > 0) is 1200-1300 Å observed: 11 columns at
    # z = 0, none at z = 1 (600-650 Å rest, below the grid)
    w = spectra_work.call_work(lam, [band], z, n_cells=3, n_taps=5)
    hand = (2 * 2 * 3 * 100 * 2   # two contractions, two rows
            + 2 * 5 * 100 * 2     # the LSF, two rows
            + 2 * 11 * 1)         # one band, 11 + 0 columns
    assert w["ops"] == hand
    assert w["contract_least_s"] == pytest.approx(
        2 * 2 * 3 * 100 * 2 / 67.0e12)
    both = spectra_work.window_work(lam, [band], [z, z[:1]], 3, 5)
    assert both["ops"] == hand + (2 * 2 * 3 * 100 + 2 * 5 * 100 + 2 * 11)
