"""Spectroscopic library generation against its plain reference.

`LibraryGenerator.generate(want_spectra=True)` through a
`SpectralFeaturePipeline` (constant R = 100 LSF, 6000-53000 Å instrument
grid, norm window 20000-30000 Å), on a seeded random grid (8 ages × 4
metallicities × 2048 log-uniform wavelengths, `benchmark/inputs.py`), 3
analytic NIRCam bands and the north-star model and prior, in 2 batches of
64 rows with a ragged n of 100, is held to `benchmark/reference/spectra.py`
on the θ it returned. The simulator takes the card's spectra route
(`photometry_backend="pallas"`: the bf16 knot product of the observed
f_ν); "auto" on the CPU would take the exact per-galaxy filter integral.

Tolerances, each from the float32 arithmetic the program does and the
reference does not (every reference step after the contractions is
float64; the contractions are exact and rounded once):
- normalised pixels (~1 in the norm window): |gap| p99 < 2e-5, max <
  5e-4. The program places each row at λ_rest(1+z) in float32 (a relative
  6e-8, 2e-5 of a grid pixel, which moves a pixel beside a sharp line by
  a few 1e-5) and sums the LSF's taps in float32; p99 read 2.2-4.6e-6 and
  max 1.8e-5-6.8e-5 over four grid seeds. The reference with its
  contractions in TF32 (the precision below the configuration's) reads
  p99 0.9-1.5e-3 and fails the p99 limit, as do a 10% wider LSF (2.4e-3)
  and a redshift off by 1e-4 (6.9e-4).
- log10 |norm|: |gap| max < 2e-6 (read ≤ 3.4e-7: float32 rounding of
  the norm's mean).
- band fluxes above 1e-3 of their row's brightest: relative gap p99 <
  1e-5, max < 2e-4 (read: p99 2.4e-7, max 5.0e-5). Both operands of the
  knot product are bf16, so a float32 rounding of the observed f_ν that
  crosses a bf16 rounding boundary moves one column of one band by up to
  2^-7 of that column: ~1e-4 of a band ~85 columns wide, as F090W is
  here. The max allows two such flips in one flux.

The band fluxes are the spectra path's own: the IGM at the galaxy's
redshift in the observed f_ν, and the plain knot matrix. The photometry
path (`reference/forward.py`, K1, K2) folds the IGM of each knot's
redshift into the knot matrix and rounds the rest-frame L_ν to bf16; at
the north-star bands and prior the two definitions differ by a median of
9.6e-5 and a p99 of 4.4e-4, and by up to 8e-5 from the IGM's placement
alone, in F090W above z = 5.6 (`reference/spectra.py`). A test below
holds that difference between float32 and bf16 rounding (p99 6.2e-4
here).

The spans of the spectra path (`sed.dense`, `sed.band_integral`,
`spectra.pipeline` with `spectra.lsf` and `spectra.resample`,
`library.draw_host`, one `library.stage` a batch and one `library.to_host`
a call, as the parts leave the card through `library._CopyOut` with no
`readback.<field>`) appear while a profiler records, and no profiler range
is made otherwise.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import inputs  # noqa: E402
from benchmark.reference.forward import (ForwardModel,  # noqa: E402
                                         tf32_first_product)
from benchmark.reference.spectra import SpectraModel  # noqa: E402

import synference_tpu_torch as tt  # noqa: E402
from synference_tpu_torch.runtime import trace_profile  # noqa: E402

MODEL = json.loads((ROOT / "benchmark" / "configs" / "north-star.json")
                   .read_text())["model"]
GRID = {"n_ages": 8, "n_mets": 4, "n_wav": 2048, "lam_min": 500.0,
        "lam_max": 1.0e5, "log10_u": -2.0, "nebular_boost": 3.0e4}
BANDS = ["JWST/NIRCam.F090W", "JWST/NIRCam.F200W", "JWST/NIRCam.F444W"]
SPECTRA = {"instrument_r": 100.0, "lam_min": 6000.0, "lam_max": 53000.0,
           "norm_window": [20000.0, 30000.0], "model_r": None}
N, BATCH, SEED = 100, 64, 2 ** 31 + 17


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    `tests/test_torch_spans.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    ga = inputs.make_grid(GRID, 5, "cpu")
    curves = inputs.make_filters(BANDS)
    grid = tt.SPSGrid(name="spectra-test", log10_ages=ga["log10_ages"],
                      metallicities=ga["metallicities"], lam=ga["lam"],
                      spectra={"incident": ga["incident"],
                               "total": ga["total"]})
    fset = tt.FilterSet([tt.Filter(code=c, lam=lam, transmission=t)
                         for c, lam, t in curves])
    dlog = float(np.diff(np.log10(ga["lam"])).mean())
    sim = tt.BatchSEDSimulator(
        grid, fset, tuple(MODEL["param_names"]), sfh=MODEL["sfh"],
        zdist=MODEL["zdist"],
        emission=tt.EmissionConfig(
            reprocessed_types=tuple(MODEL["reprocessed_types"]),
            dust_law=MODEL["dust_law"], igm=MODEL["igm"]),
        cosmology=tt.Cosmology(**MODEL["cosmology"]), z_max=MODEL["z_max"],
        photometry_knot_delta=max(1, round(MODEL["knot_spacing_dex"]
                                           / dlog)),
        photometry_backend="pallas", device="cpu")
    pipe = tt.SpectralFeaturePipeline(
        grid.lam, tt.generate_constant_r_grid(100, 6000, 53000),
        instrument_r=100, norm_window=(20000, 30000), device="cpu")
    gen = tt.LibraryGenerator(
        sim, {k: tuple(v) for k, v in MODEL["prior"].items()},
        unlog_keys=list(MODEL["unlog_keys"]), spectral_pipeline=pipe,
        device="cpu")
    lib = gen.generate(n=N, batch_size=BATCH, seed=SEED, want_spectra=True)
    ref = SpectraModel(ga, curves, MODEL, SPECTRA, "cpu")
    theta = torch.as_tensor(lib["parameters"].T.copy())
    feats, fluxes = ref.spectra(theta)
    return {"gen": gen, "lib": lib, "ref": ref, "theta": theta,
            "feats": feats, "fluxes": fluxes, "grid": ga, "curves": curves}


def _pixel_gaps(feats, ref_feats):
    return (torch.as_tensor(feats, dtype=torch.float64)[:, :-1]
            - ref_feats[:, :-1]).abs()


def _flux_gaps(phot, ref):
    phot = torch.as_tensor(phot, dtype=torch.float64)
    rel = (phot - ref).abs() / ref.abs().clamp(min=1e-30)
    return rel[ref > 1e-3 * ref.max(dim=1, keepdim=True).values]


def test_library_shape_and_instrument_grid(case):
    lib = case["lib"]
    assert lib["parameters"].shape == (6, N)
    assert lib["photometry"].shape == (len(BANDS), N)
    assert lib["spectra"].shape == (case["ref"].obs_lam.shape[0] + 1, N)
    np.testing.assert_allclose(lib["wavelengths"],
                               case["ref"].obs_lam.numpy(), rtol=1e-7)
    assert np.isfinite(lib["spectra"]).all()


def test_spectra_pixels_match_the_reference(case):
    gap = _pixel_gaps(case["lib"]["spectra"].T, case["feats"])
    assert float(torch.quantile(gap, 0.99)) < 2e-5
    assert float(gap.max()) < 5e-4


def test_norm_matches_the_reference(case):
    got = torch.as_tensor(case["lib"]["spectra"][-1], dtype=torch.float64)
    assert float((got - case["feats"][:, -1]).abs().max()) < 2e-6


def test_band_fluxes_match_the_reference(case):
    rel = _flux_gaps(case["lib"]["photometry"].T, case["fluxes"])
    assert float(torch.quantile(rel, 0.99)) < 1e-5
    assert float(rel.max()) < 2e-4


def test_tf32_first_product_fails_the_spectra_tolerance(case):
    feats, _ = case["ref"].spectra(case["theta"],
                                   first_product=tf32_first_product)
    assert float(torch.quantile(_pixel_gaps(feats, case["feats"]),
                                0.99)) > 2e-5


@pytest.mark.parametrize("fault", [{"lsf_scale": 1.1}, {"dz": 1e-4}])
def test_planted_faults_fail_the_spectra_tolerance(case, fault):
    feats, _ = case["ref"].spectra(case["theta"], **fault)
    assert float(torch.quantile(_pixel_gaps(feats, case["feats"]),
                                0.99)) > 2e-5


def test_band_definition_differs_from_the_photometry_path(case):
    """The spectra path's fluxes (IGM at the galaxy's z, observed f_ν in
    bf16) against `forward.py`'s (IGM at each knot's z, rest-frame L_ν in
    bf16): beyond float32 rounding, within the rounding of bf16
    operands."""
    fwd = ForwardModel(case["grid"], case["curves"], MODEL, "cpu")
    other = fwd.photometry(case["theta"]).double()
    p99 = float(torch.quantile(_flux_gaps(case["lib"]["photometry"].T,
                                          other), 0.99))
    assert 1e-5 < p99 < 2e-3


def _program_names(log_dir) -> list:
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return [e["name"][len("synference::"):] for e in events
            if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("synference::")]


def test_spans_appear_while_a_profiler_records(case, tmp_path):
    with trace_profile(str(tmp_path)):
        lib = case["gen"].generate(n=N, batch_size=BATCH, seed=SEED,
                                   want_spectra=True)
    names = _program_names(tmp_path)
    batches = -(-N // BATCH)
    for name in ("sed.dense", "sed.band_integral", "spectra.pipeline",
                 "spectra.lsf", "spectra.resample", "library.stage"):
        assert names.count(name) == batches, name
    for name in ("readback.photometry", "readback.spectra"):
        assert name not in names
    assert names.count("library.draw_host") == 1
    assert names.count("library.to_host") == 1
    for key in ("parameters", "photometry", "spectra"):
        np.testing.assert_array_equal(lib[key], case["lib"][key])


def test_no_profiler_makes_no_range(case, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("profiler range made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    lib = case["gen"].generate(n=N, batch_size=BATCH, seed=SEED,
                               want_spectra=True)
    np.testing.assert_array_equal(lib["spectra"], case["lib"]["spectra"])
