"""Port parity, the host-side modules: `runtime.py` (`TerminalLossPlot`,
`StepTimer`, `MetricsLogger`, `setup_logger`, `trace_profile`,
`TrainConfig(live_plot=True)`), `plotting.py` with the fitter's
`plot_diagnostics`, `run_validation_from_file` and `create_dataframe`,
`config.py` (`run_from_config`, `main`) and `testdata.py`
(`generate_test_data`, `main`).

Tolerances: `TerminalLossPlot` prints the JAX package's text character for
character for the same losses; the test-data grid file holds the JAX
package's values bitwise and the test library has the JAX package's
schema (groups, datasets, their dtypes and widths, attribute names). The
figures are a smoke test (files written, as `tests/test_mcmc_recovery.py`
checks them); trained models are readings, not parity (the two packages'
initial weights differ): a model the port trains from the reference YAML
loads in the JAX package with the configured architecture.
Deliberate differences (ROADMAP queue 3): `trace_profile` records a
`torch.profiler` trace, and `epochs_per_dispatch` (epochs fused into one
TPU program) is accepted and ignored.
"""

import contextlib
import io
import json
import logging
import sys

import h5py
import numpy as np
import pytest
import torch

import synference_tpu_torch as tt
from synference_tpu.fitter import SBIFitter as JaxFitter
from synference_tpu.runtime import TerminalLossPlot as JaxPlot
from synference_tpu.testdata import generate_test_data as jax_test_data
from synference_tpu_torch import config as tconfig
from synference_tpu_torch import testdata as ttestdata
from synference_tpu_torch.runtime import (MetricsLogger, StepTimer,
                                          TerminalLossPlot, setup_logger,
                                          trace_profile)

LOSSES = {
    "falling": [(2.0, 2.2), (1.5, 1.8), (1.2, 1.7), (1.1, 1.75)],
    "flat": [(1.0, 1.0), (1.0, 1.0), (1.0, 1.0)],
    "members": [(np.array([2.0, 3.0]), np.array([2.5, 3.5])),
                (np.array([1.0, 2.5]), np.array([1.5, 3.25]))],
    "train_only": [(3.0, None), (2.0, None), (2.5, None)],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(cls, losses, ansi, as_tensor=False, **kw):
    buf = io.StringIO()
    plot = cls(stream=buf, ansi=ansi, **kw)
    for epoch, (tr, va) in enumerate(losses):
        if as_tensor:
            tr = torch.as_tensor(tr)
            va = None if va is None else torch.as_tensor(va)
        plot.update(epoch, tr, va)
    return buf.getvalue()


@pytest.mark.parametrize("ansi", [True, False], ids=["ansi", "lines"])
@pytest.mark.parametrize("case", sorted(LOSSES))
def test_terminal_loss_plot_text_is_jax(case, ansi):
    """The same frames (ANSI overdraw) or lines as the JAX class, also
    when the losses come as tensors."""
    kw = dict(width=20, height=5, label="npe x2")
    ref = _draw(JaxPlot, LOSSES[case], ansi, **kw)
    assert _draw(TerminalLossPlot, LOSSES[case], ansi, **kw) == ref
    assert _draw(TerminalLossPlot, LOSSES[case], ansi, as_tensor=True,
                 **kw) == ref


def test_train_live_plot_draws_every_epoch():
    """`TrainConfig(live_plot=True)` prints one line per epoch to a
    non-terminal stdout: the JAX class's text for the run's history."""
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((256, 2)).astype(np.float32)
    x = (theta + 0.1 * rng.standard_normal((256, 2))).astype(np.float32)
    flow = tt.build_flow("maf", 2, 2, hidden_features=8, num_transforms=2,
                         device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tt.train_ensemble(
            flow, theta, x, torch.Generator().manual_seed(0),
            tt.TrainConfig(max_epochs=3, batch_size=64, live_plot=True),
            n_nets=2)
    ref = _draw(JaxPlot, list(zip(res.train_losses, res.val_losses)),
                ansi=False, label="npe x2")
    assert buf.getvalue() == ref and ref.count("\n") == 3


def test_step_timer_metrics_logger_and_logger(tmp_path):
    timer = StepTimer(window=5)
    for _ in range(4):
        timer.tick()
    assert timer.steps_per_sec > 0 and timer.eta_seconds(10) < np.inf
    sink = MetricsLogger(str(tmp_path / "metrics.jsonl"))
    sink.log(step=1, loss=0.5)
    sink.log(step=2, loss=0.4)
    rows = sink.read()
    assert len(rows) == 2 and rows[1]["loss"] == 0.4 and "t" in rows[0]
    logger = setup_logger("test_torch_runtime_logger")
    assert logger.name == "test_torch_runtime_logger"
    assert logger.level == logging.INFO  # rank 0 without a process group


def test_trace_profile_writes_a_torch_trace(tmp_path):
    with trace_profile(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert isinstance(prof, torch.profiler.profile)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)


def test_plotting_smoke_with_tensors(tmp_path):
    """`tests/test_mcmc_recovery.py`'s plotting smoke, inputs as tensors."""
    from synference_tpu_torch.plotting import (plot_corner, plot_coverage,
                                               plot_histograms, plot_loss,
                                               plot_posterior_predictions,
                                               plot_sed_recovery,
                                               plot_snr_binned_deviation)

    g = torch.Generator().manual_seed(0)
    samples = torch.randn((40, 100, 3), generator=g)
    truths = torch.randn((40, 3), generator=g)
    plot_coverage(samples, truths, ["a", "b", "c"],
                  save=str(tmp_path / "cov.png"))
    plot_loss(torch.rand(20, generator=g), np.random.default_rng(0).random(20),
              save=str(tmp_path / "loss.png"))
    plot_corner(samples[0], truths[0], ["a", "b", "c"],
                save=str(tmp_path / "corner.png"))
    plot_posterior_predictions(samples, truths,
                               save=str(tmp_path / "pred.png"))
    plot_snr_binned_deviation(samples, truths, torch.rand(40, generator=g)
                              * 100 + 1, save=str(tmp_path / "snr.png"))
    plot_histograms(truths, save=str(tmp_path / "hist.png"))
    rec = {"lam": torch.logspace(3, 5, 200),
           "fnu_quantiles": torch.rand((3, 200), generator=g) + 0.1,
           "sfh_quantiles": torch.rand((3, 30), generator=g) + 0.1,
           "ages_yr": np.geomspace(1e6, 1e10, 30)}
    plot_sed_recovery(rec, save=str(tmp_path / "sed.png"))
    for f in ("cov", "loss", "corner", "pred", "snr", "hist", "sed"):
        assert (tmp_path / f"{f}.png").stat().st_size > 1000


def _fitter():
    """`tests/test_fitter_extras.py`'s config fitter, on the CPU."""
    rng = np.random.default_rng(2)
    theta = rng.uniform(-1, 1, (1500, 2)).astype(np.float32)
    x = (theta + 0.1 * rng.standard_normal((1500, 2))).astype(np.float32)
    fitter = tt.SBIFitter(np.abs(x) + 1.0, theta, ("a", "b"), ("F1", "F2"),
                          device="cpu")
    fitter.features, fitter.feature_params = x, theta
    fitter.feature_source = np.arange(len(x))
    return fitter


REFERENCE_YAML = (
    "train_args:\n"
    "  skip_optimization: True\n"
    "  validation_fraction: 0.1\n"
    "  epochs_per_dispatch: 4\n"
    "  fixed_params:\n"
    "    model_choice: \"mdn\"\n"
    "    learning_rate: 0.001\n"
    "    training_batch_size: 128\n"
    "    stop_after_epochs: 4\n"
    "    clip_max_norm: 5.0\n"
    "    mdn_hidden_features: 16\n"
    "    mdn_num_components: 2\n"
    "max_epochs: 5\n")


def test_run_from_config_reference_yaml(tmp_path):
    """The reference YAML of `tests/test_fitter_extras.py` (plus
    `epochs_per_dispatch`, accepted and ignored) trains an mdn; the saved
    model loads in both packages with that architecture."""
    out = tmp_path / "model.pkl"
    cfg_path = tmp_path / "best_params.yaml"
    cfg_path.write_text(REFERENCE_YAML + f"output: {out}\n")
    fitter = tt.run_from_config(str(cfg_path), fitter=_fitter(),
                                device="cpu")
    assert fitter.posterior is not None
    assert fitter.flow.spec()["model"] == "mdn"
    assert fitter.train_result.train_losses.shape[0] <= 5
    loaded = tt.SBIFitter.load_saved_model(str(out), device="cpu")
    assert loaded.flow.spec()["config"]["num_components"] == 2
    jloaded = JaxFitter.load_saved_model(str(out))
    assert jloaded.flow.spec()["config"]["num_components"] == 2


def test_json_config_library_and_cli(tmp_path, monkeypatch):
    """A JSON config needs no yaml: it names an HDF5 library and features,
    and the CLI trains on `--device cpu`; `--device cuda` raises where
    there is no card; an optuna block runs the HPO study (two trials) and
    keeps it on the fitter."""
    lib = tt.LibraryGenerator(
        tt.AGNGridSimulator(tt.make_synthetic_agn_grid(n_u=3, n_nh=2,
                                                       n_wav=512),
                            tt.FilterSet([tt.tophat_filter(
                                f"F{i}", c, 3000.0) for i, c in enumerate(
                                    (9000.0, 15000.0, 20000.0))]),
                            device="cpu"),
        {"log10_l_agn": (44.0, 47.0), "redshift": (0.1, 6.0),
         "ionisation_parameter": (-3.0, 0.0), "hydrogen_density": (2.0, 6.0),
         "covering_fraction_blr": (0.0, 0.3),
         "covering_fraction_nlr": (0.0, 0.5), "tau_v": (0.0, 1.5)},
        device="cpu")
    path = str(tmp_path / "agn.h5")
    lib.generate(n=512, batch_size=512, out_path=path)
    cfg = {"library": path, "max_epochs": 2, "output": str(tmp_path / "m.pkl"),
           "features": {"unit": "asinh", "depths_ab": [28.0, 28.0, 28.0],
                        "include_errors": True},
           "train_args": {"fixed_params": {"model_choice": "nsf",
                                           "nsf_hidden_features": 8,
                                           "nsf_num_transforms": 2}}}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises
    assert tconfig.load_config(str(cfg_path)) == cfg
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert tconfig.main([str(cfg_path), "--device", "cpu"]) == 0
    assert buf.getvalue().startswith("TARP deviation:")
    assert (tmp_path / "m.pkl").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tconfig.main([str(cfg_path)])
    cfg["train_args"] = {
        "skip_optimization": False,
        "fixed_params": {"model_choice": "nsf"},
        "optuna": {"n_trials": 2, "build_final_model": False,
                   "search_space": {
                       "hidden_features": ["categorical", [8]],
                       "num_transforms": ["categorical", [2]],
                       "learning_rate": ["float", 1e-3, 1e-2, "log"]}}}
    cfg["verbose"] = False
    fitter = tt.run_from_config(cfg, device="cpu")
    assert len(fitter.hpo_study.trials) == 2
    assert all(t["state"] in ("COMPLETE", "PRUNED")
               for t in fitter.hpo_study.trials)


def test_fitter_figures_validation_and_dataframe(tmp_path):
    """`plot_diagnostics`, `run_validation_from_file` (the saved model
    reloaded onto the fitter's device, draws from a generator there) and
    `create_dataframe` on a small trained fitter."""
    fitter = _fitter()
    fitter.run_single_sbi("nsf", hidden_features=8, num_transforms=2,
                          train_config=tt.TrainConfig(max_epochs=2))
    paths = fitter.plot_diagnostics(str(tmp_path), n_samples=50,
                                    max_objects=40)
    assert sorted(paths) == ["coverage", "loss", "predictions"]
    saved = str(tmp_path / "model.pkl")
    fitter.save_state(saved)
    report, vpaths = fitter.run_validation_from_file(
        saved, plots_dir=str(tmp_path / "val"), n_samples=50, max_objects=40,
        generator=torch.Generator().manual_seed(3))
    assert np.isfinite(report["tarp_deviation"])
    for p in list(paths.values()) + list(vpaths.values()):
        assert (tmp_path / p).stat().st_size > 100
    with open(vpaths["metrics"]) as f:
        assert "tarp_deviation" in json.load(f)
    frame = fitter.create_dataframe()
    assert list(frame.columns) == ["a", "b", "F1", "F2"]
    assert frame.shape == (1500, 4)
    assert fitter.create_dataframe("features").shape == (1500, 2)
    with pytest.raises(ValueError, match="no data"):
        fitter.create_dataframe("supplementary")


def _schema(path):
    out = {"/": sorted(h5py.File(path).attrs)}
    with h5py.File(path) as f:
        f.visititems(lambda name, obj: out.__setitem__(name, (
            type(obj).__name__, getattr(obj, "dtype", None),
            getattr(obj, "shape", (None,))[:1], sorted(obj.attrs))))
    return out


def test_generate_test_data_matches_jax(tmp_path):
    """The grid file equals the JAX package's value for value; the library
    has its schema (the JAX side writes an empty library: its schema is
    that of a full one, without simulating); the CLI takes `--device`."""
    port = ttestdata.generate_test_data(str(tmp_path / "port"), n=64,
                                          verbose=False, device="cpu")
    ref = jax_test_data(str(tmp_path / "jax"), n=0, verbose=False)
    with h5py.File(port["grid"]) as a, h5py.File(ref["grid"]) as b:
        names, ref_names = [], []
        a.visit(names.append)
        b.visit(ref_names.append)
        assert names and names == ref_names
        for name in names:
            if isinstance(a[name], h5py.Dataset):
                np.testing.assert_array_equal(a[name][()], b[name][()])
    assert _schema(port["library"]) == _schema(ref["library"])
    lib = tt.load_library_hdf5(port["library"])
    assert lib["photometry"].shape == (7, 64)
    assert np.isfinite(lib["photometry"]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttestdata.main(["--out", str(tmp_path / "cli"), "--n", "8"])
