"""Pacman emission with a free escape fraction on the window engine against
its plain reference.

The `pacman` configuration's model (north-star's with fesc a θ column: the
incident light escapes unscreened, the reprocessed "total" light sits
behind the Calzetti ISM screen, L = fesc·incident + (1 − fesc)·total·
exp(−τ_V k)) on a seeded random grid (8 ages × 5 metallicities × 2048
log-uniform wavelengths, `benchmark/inputs.py`) and 3 analytic NIRCam
bands, held to `benchmark/reference/pacman.py` on the θ the program
returned, with the rows' fesc as drawn and again with a third of them at
fesc = 0 and a third at fesc = 1:
- `generate` on the device sampler (z sort, one plan, the staged window
  body), interp and conv, in 3 batches of 128 with a ragged n of 300;
- dense `photometry` on the pallas backend: K2's plain version, and the
  full-table plain route `_photometry_fused` (`_mega_off`);
- `fused_window_photometry_grouped_reference`,
  `fused_sed_photometry_reference` and their exact first products, on the
  simulator's own arguments (`_window_grouped_args`, `_screens`), and the
  one-sub-chunk plain K1 on `_window_calls`' arguments.

Tolerance, as the cf00 cell's, on fluxes above 1e-3 of their row's
brightest: relative gap p99 < 1e-5 (the cell's `flux_rel_p99` limit) and
max < 2e-4. The program's first products are float32 (the reference's
exact), so a float32 rounding of a flux that crosses a bf16 rounding
boundary of the knot product's input moves one column of one band by up
to 2^-7 of that column: ~1e-4 of a band ~85 columns wide, as F090W is
here; the max allows two such flips in one flux. The reference with its
first products in TF32 (the precision below the configuration's) fails
the p99 limit, as do fesc read as 0 and the escaped light screened.

The cell's traffic driver (`benchmark/drivers/pacman.py`) at a tiny size
on the CPU: the program passes every check of the workload file's limits,
and the TF32 control and both planted faults fail `flux_rel_p99`.

The gate opens for this model (K1 on a card; the staged body here), and
for a θ-column fesc with no reprocessed types; it stays shut for a
θ-column fesc beside the birth cloud, for dust emission and for the AGN
simulators. The span `sed.screens` (the per-row inputs: τ_V and fesc)
appears once a batch while a profiler records, and no profiler range is
made otherwise.
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
from benchmark.reference.forward import tf32_first_product  # noqa: E402
from benchmark.reference.pacman import PacmanModel  # noqa: E402

import synference_tpu_torch as tt  # noqa: E402
from synference_tpu_torch.ops import fused_sed as fs  # noqa: E402
from synference_tpu_torch.runtime import trace_profile  # noqa: E402

MODEL = json.loads((ROOT / "benchmark" / "configs" / "pacman.json")
                   .read_text())["model"]
GRID = {"n_ages": 8, "n_mets": 5, "n_wav": 2048, "lam_min": 500.0,
        "lam_max": 1.0e5, "log10_u": -2.0, "nebular_boost": 3.0e4}
BANDS = ["JWST/NIRCam.F090W", "JWST/NIRCam.F200W", "JWST/NIRCam.F444W"]
N, BATCH, SEED = 300, 128, 2 ** 31 + 25
I_FESC = MODEL["param_names"].index("fesc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    `tests/test_torch_spans.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _emission(**kw):
    args = dict(incident_type=MODEL["incident_type"],
                reprocessed_types=tuple(MODEL["reprocessed_types"]),
                fesc=MODEL["fesc"], dust_law=MODEL["dust_law"],
                tau_v_bc_param=MODEL["tau_v_bc_param"], igm=MODEL["igm"])
    return tt.EmissionConfig(**dict(args, **kw))


@pytest.fixture(scope="module")
def grid():
    ga = inputs.make_grid(GRID, 7, "cpu")
    curves = inputs.make_filters(BANDS)
    sps = tt.SPSGrid(name="pacman-test", log10_ages=ga["log10_ages"],
                     metallicities=ga["metallicities"], lam=ga["lam"],
                     spectra={"incident": ga["incident"],
                              "total": ga["total"]})
    fset = tt.FilterSet([tt.Filter(code=c, lam=lam, transmission=t)
                         for c, lam, t in curves])
    return {"arrays": ga, "curves": curves, "sps": sps, "filters": fset,
            "ref": PacmanModel(ga, curves, MODEL, "cpu")}


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


def _ends(theta):
    """θ with its first third at fesc = 0, its second at fesc = 1 and the
    rest as drawn (the row order, and so the z sort, kept)."""
    theta = theta.clone()
    third = theta.shape[0] // 3
    theta[:third, I_FESC] = 0.0
    theta[third:2 * third, I_FESC] = 1.0
    return theta


@pytest.fixture(scope="module")
def libs(grid):
    out = {}
    for variant in ("interp", "conv"):
        gen = _generator(_sim(grid, variant))
        lib = gen.generate(n=N, batch_size=BATCH, seed=SEED)
        theta = torch.as_tensor(lib["parameters"].T.copy())
        out[variant] = {"gen": gen, "lib": lib, "theta": theta,
                        "ref": grid["ref"].photometry(theta).double()}
    theta = _ends(out["interp"]["theta"])
    out["ends"] = {"theta": theta,
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


@pytest.mark.parametrize("variant", ["interp", "conv"])
def test_generate_takes_the_window_engine_and_matches(libs, variant):
    case = libs[variant]
    sim = case["gen"].simulator
    assert sim._window_supported()
    assert sim._window_mega_supported() == (variant == "interp")
    names = sim.param_names
    z = case["lib"]["parameters"][names.index("redshift")]
    assert np.all(np.diff(z) >= 0)  # the device sampler sorted the rows
    fesc = case["lib"]["parameters"][I_FESC]
    assert 0.0 <= fesc.min() and fesc.max() <= 1.0
    _assert_close(case["lib"]["photometry"].T, case["ref"])


@pytest.mark.parametrize("variant", ["interp", "conv"])
def test_staged_body_at_the_ends_of_fesc(libs, variant):
    """fesc = 0 (all light screened), 1 (all escaped) and as drawn, through
    the staged window body at the run's plan."""
    sim = libs[variant]["gen"].simulator
    ends = libs["ends"]
    out = sim.photometry_zsorted_device(ends["theta"], sub_chunk=64)
    _assert_close(out, ends["ref"])


@pytest.mark.parametrize("mega_off", [False, True])
@pytest.mark.parametrize("rows", ["drawn", "ends"])
def test_dense_photometry_matches(libs, mega_off, rows):
    case = libs["interp"] if rows == "drawn" else libs["ends"]
    sim = libs["interp"]["gen"].simulator
    assert sim._mega_supported()
    sim._mega_off = mega_off
    try:
        out = sim.photometry(case["theta"])
    finally:
        sim._mega_off = False
    _assert_close(out, case["ref"])


@pytest.mark.parametrize("first_product", [torch.matmul,
                                           fs.exact_first_product])
@pytest.mark.parametrize("rows", ["drawn", "ends"])
def test_kernel_plain_versions_match(libs, first_product, rows):
    case = libs["interp"] if rows == "drawn" else libs["ends"]
    sim, theta = libs["interp"]["gen"].simulator, case["theta"]
    chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(theta, 64)
    args = sim._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)
    assert args["fesc"] == 0.0 and "tau_bc" not in args
    assert args["fesc_row"].shape == (len(chunk),)
    assert torch.equal(args["fesc_row"], chunk[:, I_FESC])
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


def test_one_sub_chunk_plain_k1_matches(libs):
    """`_window_calls` hands each sub-chunk its window of the incident table
    beside the reprocessed one: the one-sub-chunk K1 (plain here) gives the
    grouped plain K1's fluxes."""
    sim, theta = libs["interp"]["gen"].simulator, libs["ends"]["theta"]
    chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(theta, 64)
    grouped = fs.fused_window_photometry_grouped_reference(
        **sim._window_grouped_args(chunk, sub, w_cols, kc, k0, l0))
    for r, cols, _, kw in sim._window_calls(chunk, sub, w_cols, kc, k0, l0):
        assert kw["sed_inc"].shape == kw["sed_w"].shape
        assert torch.equal(kw["sed_inc"],
                           sim._mega_tables["inc"][:, cols])
        assert torch.equal(fs.fused_window_photometry(**kw), grouped[r])


def test_zero_fesc_is_the_screen_alone(libs):
    """fesc = 0 everywhere: the escape plain K1 gives the one-screen plain
    K1's fluxes on the reprocessed table."""
    sim, theta = libs["interp"]["gen"].simulator, libs["interp"]["theta"]
    chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(theta, 64)
    args = sim._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)
    args["fesc_row"] = torch.zeros_like(args["fesc_row"])
    one = {k: v for k, v in args.items() if k != "fesc_row"}
    out = fs.fused_window_photometry_grouped_reference(
        **args, first_product=fs.exact_first_product)
    ref = fs.fused_window_photometry_grouped_reference(
        **one, first_product=fs.exact_first_product)
    assert float(_flux_gaps(out, ref.double()).max()) < 1e-6


def test_kernel_input_checks(libs):
    """The card wrappers' input checks, run on CPU tensors: a per-row fesc
    needs the incident table of the batch's shape, and refuses the birth
    cloud beside it."""
    sim, theta = libs["interp"]["gen"].simulator, libs["interp"]["theta"]
    chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(theta, 64)
    _, _, _, kw = next(sim._window_calls(chunk, sub, w_cols, kc, k0, l0))
    names = ("sfzh", "s_rel", "tau_v", "scale", "sed_w", "curve_w", "knot_w",
             "den_w", "kc", "delta", "f8", "order")
    pos = [kw[k] for k in names]
    pos[names.index("knot_w")] = kw["knot_w"].to(torch.bfloat16)
    fs._check_cuda_inputs(*pos, fesc_row=kw["fesc_row"],
                          sed_inc=kw["sed_inc"])
    for bad, match in (
            (dict(fesc_row=kw["fesc_row"]), "incident table"),
            (dict(fesc_row=kw["fesc_row"][:-1], sed_inc=kw["sed_inc"]),
             "fesc_row has shape"),
            (dict(fesc_row=kw["fesc_row"], sed_inc=kw["sed_inc"][:, :-1]),
             "sed_inc has shape"),
            (dict(fesc_row=kw["fesc_row"], sed_inc=kw["sed_inc"],
                  tau_bc=kw["tau_v"], n_young=1), "together")):
        with pytest.raises(ValueError, match=match):
            fs._check_cuda_inputs(*pos, **bad)


@pytest.mark.parametrize("fault", [
    {"first_product": tf32_first_product}, {"fesc_ignored": True},
    {"escape_screened": True}])
def test_control_and_faults_fail_the_tolerance(grid, libs, fault):
    case = libs["interp"]
    bad = grid["ref"].photometry(case["theta"], **fault)
    assert float(torch.quantile(_flux_gaps(bad, case["ref"]), 0.99)) > 1e-5


def test_device_draw_stratifies_fesc(libs):
    """The device sampler gives fesc its own Latin-hypercube axis: each of
    n equal strata of [0, 1] holds exactly one row."""
    gen = libs["interp"]["gen"]
    n = 256
    theta = gen.sample_parameters_device(
        n, torch.Generator().manual_seed(SEED))
    counts = np.bincount((theta[:, I_FESC].double().numpy() * n)
                         .astype(np.int64).clip(0, n - 1), minlength=n)
    assert (counts == 1).all()


def test_gate_opens_without_reprocessed_types(grid):
    """fesc a θ column with the incident light alone: both parts read the
    one table, and the staged body and dense K2 route agree (no IGM: the
    gate does not read it, and its tables take most of a build here)."""
    sim = _sim(grid, reprocessed_types=(), igm="none")
    assert sim._window_mega_supported() and sim._mega_supported()
    assert sim._mega_tables["inc"] is sim._mega_tables["sed"]
    theta = torch.as_tensor(_generator(sim).generate(
        n=128, batch_size=128, seed=SEED)["parameters"].T.copy())
    _assert_close(sim.photometry(theta),
                  sim.photometry_zsorted_device(theta, sub_chunk=64).double())


@pytest.mark.parametrize("kw", [
    {"tau_v_bc_param": "tau_v_bc"}, {"dust_emission": True}])
def test_gate_stays_shut(grid, kw):
    names = MODEL["param_names"] + (["tau_v_bc"] if "tau_v_bc_param" in kw
                                    else [])
    sim = _sim(grid, names=names, igm="none", **kw)
    assert not sim._window_supported()
    assert not sim._window_mega_supported() and not sim._mega_supported()


def test_gate_stays_shut_for_agn(grid):
    sim = tt.AGNSimulator(
        grid["sps"], grid["filters"],
        ("log10_l_agn", "redshift", "agn_slope", "tau_v", "fesc"),
        emission=_emission(igm="none"), photometry_backend="pallas",
        device="cpu")
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
    wl = harness.load_json("workloads", "pacman.generate")
    cfg = harness.load_json("configs", wl["config"])
    cfg["grid"].update(n_ages=8, n_mets=5, n_wav=1024)
    cfg["filters"] = cfg["filters"][:3]
    wl["params"].update(rows_per_call=4096, warmup_calls=1,
                        sample_rows_per_call=16, max_sample_rows=256,
                        strata=64)
    driver = harness.load_module("drivers", wl["driver"])
    ctx = harness.Run("pacman.generate", SEED, 0.2, False, "cpu", cfg,
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


def test_cell_driver_counts_both_first_products():
    """The driver's work a row is the Pacman model's: 4·C·L_row + 2·L_row·F
    operations, and both tables' covered columns among the bytes."""
    from benchmark import workcount

    driver = harness.load_module("drivers", "pacman")
    ga = inputs.make_grid(GRID, 7, "cpu")
    support = workcount.band_support(inputs.make_filters(BANDS))
    z = np.linspace(0.5, 3.0, 64)
    one = workcount.launch_work(ga["lam"], support, z, 40, 3)
    two = driver.launch_work(ga["lam"], support, z, 40, 3)
    cols = workcount.columns_per_row(ga["lam"], support, z).sum()
    assert two["ops"] - one["ops"] == pytest.approx(2.0 * 40 * cols)
    covered = workcount.columns_covered(ga["lam"], support, z)
    assert two["bytes"] - one["bytes"] == pytest.approx(
        4.0 * (40 * covered + 64))
