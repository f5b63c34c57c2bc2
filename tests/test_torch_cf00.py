"""Charlot & Fall (2000) dust on the window engine against its plain
reference.

The `cf00` configuration's model (north-star's with two screens: the ISM
τ_V over every star and the birth cloud τ_BC over the stars younger than
10^7 yr, both (λ/5500 Å)^−0.7, fesc 0) on a seeded random grid (8 ages ×
5 metallicities × 2048 log-uniform wavelengths, `benchmark/inputs.py`;
3 of its ages are young, so the young cells are the first 15 of 40, a
prefix that is not a multiple of 4) and 3 analytic NIRCam bands, held to
`benchmark/reference/cf00.py` on the θ the program returned:
- `generate` on the device sampler (z sort, one plan, the staged window
  body), interp and conv, in 3 batches of 128 with a ragged n of 300;
- dense `photometry` on the pallas backend: K2's plain version, and the
  full-table plain route `_photometry_fused` (`_mega_off`);
- `fused_window_photometry_grouped_reference`,
  `fused_sed_photometry_reference` and their exact first products, on the
  simulator's own arguments (`_window_grouped_args`, `_screens`).

Tolerance, on fluxes above 1e-3 of their row's brightest: relative gap
p99 < 1e-5 (the cell's `flux_rel_p99` limit) and max < 2e-4. The
program's first products are float32 (the reference's exact), so a
float32 rounding of a screened flux that crosses a bf16 rounding boundary
of the knot product's input moves one column of one band by up to 2^-7
of that column: ~1e-4 of a band ~85 columns wide, as F090W is here. The
max allows two such flips in one flux. Read here: p99 2.5-3.0e-7, max
3.7e-7 to 6.8e-5 (one flip). The reference with its first products in
TF32 (the precision below the configuration's) reads p99 4.2e-4 and
fails the p99 limit, as do the birth cloud dropped (1.6) and the split
one grid age late (0.76).

The cell's traffic driver (`benchmark/drivers/cf00.py`) at a tiny size
on the CPU: the program passes every check of the workload file's limits,
and the TF32 control and both planted faults fail `flux_rel_p99`.

The gate opens for this model (K1 on a card; the staged body here) and
stays shut for fesc as a θ column, a static fesc beside the birth cloud,
dust emission and the AGN simulators. The span `sed.screens` (the
screens' per-row inputs) appears once a batch while a profiler records,
and no profiler range is made otherwise.
"""

import json
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, inputs  # noqa: E402
from benchmark.reference.cf00 import CF00Model  # noqa: E402
from benchmark.reference.forward import tf32_first_product  # noqa: E402

import synference_tpu_torch as tt  # noqa: E402
from synference_tpu_torch.ops import fused_sed as fs  # noqa: E402
from synference_tpu_torch.runtime import trace_profile  # noqa: E402

MODEL = json.loads((ROOT / "benchmark" / "configs" / "cf00.json")
                   .read_text())["model"]
GRID = {"n_ages": 8, "n_mets": 5, "n_wav": 2048, "lam_min": 500.0,
        "lam_max": 1.0e5, "log10_u": -2.0, "nebular_boost": 3.0e4}
BANDS = ["JWST/NIRCam.F090W", "JWST/NIRCam.F200W", "JWST/NIRCam.F444W"]
N, BATCH, SEED = 300, 128, 2 ** 31 + 17


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    `tests/test_torch_spans.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _emission(**kw):
    args = dict(reprocessed_types=tuple(MODEL["reprocessed_types"]),
                fesc=float(MODEL["fesc"]), dust_law=MODEL["dust_law"],
                dust_params=tuple(MODEL["dust_params"].items()),
                tau_v_param=MODEL["tau_v_param"],
                tau_v_bc_param=MODEL["tau_v_bc_param"],
                age_pivot_log10=MODEL["age_pivot_log10"], igm=MODEL["igm"])
    return tt.EmissionConfig(**dict(args, **kw))


@pytest.fixture(scope="module")
def grid():
    ga = inputs.make_grid(GRID, 5, "cpu")
    curves = inputs.make_filters(BANDS)
    sps = tt.SPSGrid(name="cf00-test", log10_ages=ga["log10_ages"],
                     metallicities=ga["metallicities"], lam=ga["lam"],
                     spectra={"incident": ga["incident"],
                              "total": ga["total"]})
    fset = tt.FilterSet([tt.Filter(code=c, lam=lam, transmission=t)
                         for c, lam, t in curves])
    return {"arrays": ga, "curves": curves, "sps": sps, "filters": fset,
            "ref": CF00Model(ga, curves, MODEL, "cpu")}


def _sim(grid, variant="interp", names=None, **emission):
    dlog = float(np.diff(np.log10(grid["arrays"]["lam"])).mean())
    return tt.BatchSEDSimulator(
        grid["sps"], grid["filters"], tuple(names or MODEL["param_names"]),
        sfh=MODEL["sfh"], zdist=MODEL["zdist"], emission=_emission(**emission),
        cosmology=tt.Cosmology(**MODEL["cosmology"]), z_max=MODEL["z_max"],
        photometry_knot_delta=max(1, round(MODEL["knot_spacing_dex"]
                                           / dlog)),
        photometry_variant=variant, photometry_backend="pallas",
        device="cpu")


def _generator(sim):
    return tt.LibraryGenerator(
        sim, {k: tuple(v) for k, v in MODEL["prior"].items()},
        unlog_keys=list(MODEL["unlog_keys"]), device="cpu")


@pytest.fixture(scope="module")
def libs(grid):
    out = {}
    for variant in ("interp", "conv"):
        gen = _generator(_sim(grid, variant))
        lib = gen.generate(n=N, batch_size=BATCH, seed=SEED)
        theta = torch.as_tensor(lib["parameters"].T.copy())
        out[variant] = {"gen": gen, "lib": lib, "theta": theta,
                        "ref": grid["ref"].photometry(theta).double()}
    return out


def _flux_gaps(phot, ref):
    phot = torch.as_tensor(phot, dtype=torch.float64)
    rel = (phot - ref).abs() / ref.abs().clamp(min=1e-30)
    return rel[ref > 1e-3 * ref.max(dim=1, keepdim=True).values]


def _assert_close(phot, ref):
    rel = _flux_gaps(phot, ref)
    assert float(torch.quantile(rel, 0.99)) < 1e-5
    assert float(rel.max()) < 2e-4


def test_young_cells_are_a_prefix(grid):
    sim = _sim(grid)
    ages = grid["arrays"]["log10_ages"]
    assert sim._n_young == int(np.sum(ages < 7.0)) * len(
        grid["arrays"]["metallicities"]) == 15
    assert torch.equal(torch.repeat_interleave(
        sim._young_mask, sim.grid.cells_per_age)[:15], torch.ones(15))
    with pytest.raises(AssertionError, match="ascend"):
        tt.BatchSEDSimulator._young_prefix(
            tt.SPSGrid(name="descending", log10_ages=ages[::-1].copy(),
                       metallicities=grid["arrays"]["metallicities"],
                       lam=grid["arrays"]["lam"],
                       spectra={"total": grid["arrays"]["total"][::-1]}),
            7.0)


@pytest.mark.parametrize("variant", ["interp", "conv"])
def test_generate_takes_the_window_engine_and_matches(libs, variant):
    case = libs[variant]
    sim = case["gen"].simulator
    assert sim._window_supported()
    assert sim._window_mega_supported() == (variant == "interp")
    z = case["lib"]["parameters"][sim.param_names.index("redshift")]
    assert np.all(np.diff(z) >= 0)  # the device sampler sorted the rows
    _assert_close(case["lib"]["photometry"].T, case["ref"])


@pytest.mark.parametrize("mega_off", [False, True])
def test_dense_photometry_matches(libs, mega_off):
    case = libs["interp"]
    sim = case["gen"].simulator
    assert sim._mega_supported()
    sim._mega_off = mega_off
    try:
        out = sim.photometry(case["theta"])
    finally:
        sim._mega_off = False
    _assert_close(out, case["ref"])


@pytest.mark.parametrize("first_product", [torch.matmul,
                                           fs.exact_first_product])
def test_kernel_plain_versions_match(libs, first_product):
    case = libs["interp"]
    sim, theta = case["gen"].simulator, case["theta"]
    chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(theta, 64)
    args = sim._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)
    assert args["n_young"] == 15 and args["tau_bc"].shape == (len(chunk),)
    out = fs.fused_window_photometry_grouped_reference(
        **args, first_product=first_product)
    _assert_close(out[:N, :len(BANDS)], case["ref"])
    params = sim.theta_dict(theta)
    sfzh, _ = sim._sfzh(params)
    z = params["redshift"]
    out = fs.fused_sed_photometry_reference(
        sfzh, sim._shift_of_z(z), scale=sim._scale_of_z(z),
        tables=sim._mega_tables, n_knots=sim._n_knots,
        delta=sim._knot_delta, f8=sim._f8, order=sim._interp_order,
        first_product=first_product, **sim._screens(params, params["tau_v"]))
    _assert_close(out[:, :len(BANDS)], case["ref"])


def test_zero_birth_cloud_is_the_ism_screen_alone(libs):
    """τ_BC = 0 everywhere: the two-screen plain K1 gives the one-screen
    plain K1's fluxes (the young part times exp(0) = 1)."""
    sim, theta = libs["interp"]["gen"].simulator, libs["interp"]["theta"]
    chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(theta, 64)
    args = sim._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)
    args["tau_bc"] = torch.zeros_like(args["tau_bc"])
    one = {k: v for k, v in args.items() if k not in ("tau_bc", "n_young")}
    out = fs.fused_window_photometry_grouped_reference(
        **args, first_product=fs.exact_first_product)
    ref = fs.fused_window_photometry_grouped_reference(
        **one, first_product=fs.exact_first_product)
    rel = _flux_gaps(out, ref.double())
    assert float(rel.max()) < 1e-6


@pytest.mark.parametrize("fault", [
    {"first_product": tf32_first_product}, {"drop_bc": True},
    {"pivot_shift": 1}])
def test_control_and_faults_fail_the_tolerance(grid, libs, fault):
    case = libs["interp"]
    bad = grid["ref"].photometry(case["theta"], **fault)
    assert float(torch.quantile(_flux_gaps(bad, case["ref"]), 0.99)) > 1e-5


@pytest.mark.parametrize("kw", [
    {"fesc": "fesc"}, {"fesc": 0.2, "reprocessed_types": ()},
    {"dust_emission": True}])
def test_gate_stays_shut(grid, kw):
    names = MODEL["param_names"] + (["fesc"] if kw.get("fesc") == "fesc"
                                    else [])
    sim = _sim(grid, names=names, **kw)
    assert not sim._window_supported()
    assert not sim._window_mega_supported() and not sim._mega_supported()


def test_gate_stays_shut_for_agn(grid):
    sim = tt.AGNSimulator(
        grid["sps"], grid["filters"],
        ("log10_l_agn", "redshift", "agn_slope", "tau_v", "tau_v_bc"),
        emission=_emission(), photometry_backend="pallas", device="cpu")
    assert sim._n_young == 15
    assert not sim._window_supported() and not sim._mega_supported()


def _program_names(log_dir) -> list:
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return [e["name"][len("synference::"):] for e in events
            if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("synference::")]


def test_screens_span_appears_while_a_profiler_records(libs, tmp_path):
    gen = libs["interp"]["gen"]
    with trace_profile(str(tmp_path)):
        lib = gen.generate(n=N, batch_size=BATCH, seed=SEED)
    names = _program_names(tmp_path)
    assert names.count("sed.screens") == -(-N // BATCH)
    np.testing.assert_array_equal(lib["photometry"],
                                  libs["interp"]["lib"]["photometry"])


def test_no_profiler_makes_no_range(libs, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("profiler range made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    lib = libs["interp"]["gen"].generate(n=N, batch_size=BATCH, seed=SEED)
    np.testing.assert_array_equal(lib["photometry"],
                                  libs["interp"]["lib"]["photometry"])


def test_cell_driver_passes_and_its_control_and_faults_fail():
    wl = harness.load_json("workloads", "cf00.generate")
    cfg = harness.load_json("configs", wl["config"])
    cfg["grid"].update(n_ages=8, n_mets=5, n_wav=1024)
    cfg["filters"] = cfg["filters"][:3]
    wl["params"].update(rows_per_call=4096, warmup_calls=1,
                        sample_rows_per_call=16, max_sample_rows=256,
                        strata=64)
    driver = harness.load_module("drivers", wl["driver"])
    ctx = harness.Run("cf00.generate", SEED, 0.2, False, "cpu", cfg,
                      wl["params"], wl["limits"], time.perf_counter())
    out = driver.run(ctx)
    state = out.pop("state")
    assert out["attempted"] >= 1 and out["failed"] == 0
    program = driver.check(ctx, state)
    assert {k for k, _, _ in program} == set(wl["limits"])
    assert all(v <= lim for _, v, lim in program), program
    limit = wl["limits"]["flux_rel_p99"]
    assert driver.control(ctx, state)["flux_rel_p99"] > limit
    for name, got in driver.faults(ctx, state).items():
        assert got["flux_rel_p99"] > limit, name
