"""Port parity, composite models and library combination:
`CompositeSEDSimulator` (a stellar `BatchSEDSimulator` plus an
`AGNGridSimulator`), its `agn_fraction`, `grid_combinations` and
`combine_libraries` / `combine_libraries_matched` against the JAX package.

Setup: the 32×5×512 stellar test grid and a 3 × 2 × 512 AGN grid, 7
tophat bands, both simulators on the "xla" backend (the exact route; the
card's routes, K2 for the stellar part and `_photometry_fused` for the
AGN part, are held to their plain versions in `tests/test_torch_cuda.py`
and `chip_smoke.py` phase 25); the toy libraries of
`tests/test_combine.py`.

Tolerances:
- composite photometry and spectra from θ: |Δ| < 1e-4 of the row's largest
  value, the stellar end-to-end bound of `tests/test_torch_dense.py` (SFH
  bin masses are CDF differences that the packages round an ulp apart);
- `agn_fraction`: |Δ| < 1e-5 (a ratio of the same spectra's integrals).
  The port returns a tensor on the composite's device, the JAX package a
  numpy array: a deliberate difference (ROADMAP queue 3), checked here;
- `grid_combinations`: bitwise equal;
- `combine_libraries[_matched]`: bitwise equal (the same float64 numpy
  arithmetic, then float32), and errors of the same type and message.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu.combine import combine_libraries as jax_combine
from synference_tpu.combine import combine_libraries_matched as jax_matched
from synference_tpu.composite import grid_combinations as jax_grid_comb
from synference_tpu.library import load_library_hdf5 as jax_load_library

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
_CODES = ["F090W", "F115W", "F150W", "F200W", "F277W", "F356W", "F444W"]
_CENTERS = [9000., 11500., 15000., 20000., 27700., 35600., 44400.]
_WIDTHS = [2000., 2600., 3300., 4600., 7000., 7800., 10200.]
RANGES = {"redshift": (0.2, 5.0), "stars.log10_mass": (8.5, 11.0),
          "stars.peak_age": (1e8, 8e8), "stars.tau": (0.2, 0.8),
          "stars.log10_metallicity": (-3.0, -2.0), "stars.tau_v": (0.0, 1.0),
          "agn.log10_l_agn": (42.0, 46.5),
          "agn.ionisation_parameter": (-3.0, 0.0),
          "agn.hydrogen_density": (2.0, 6.0),
          "agn.covering_fraction_blr": (0.0, 0.3),
          "agn.covering_fraction_nlr": (0.0, 0.5),
          "agn.tau_v": (0.0, 1.5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _composite(pkg):
    kw = dict(photometry_backend="xla")
    if pkg is tt:
        kw["device"] = "cpu"
    filters = pkg.FilterSet([pkg.tophat_filter(c, ct, w) for c, ct, w in
                             zip(_CODES, _CENTERS, _WIDTHS)])
    stars = pkg.BatchSEDSimulator(
        pkg.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0),
        filters, PNAMES, sfh="lognormal", zdist="delta",
        emission=pkg.EmissionConfig(), **kw)
    agn = pkg.AGNGridSimulator(
        pkg.make_synthetic_agn_grid(n_u=3, n_nh=2, n_wav=512), filters, **kw)
    return pkg.CompositeSEDSimulator({"stars": stars, "agn": agn})


def _theta(names, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(*RANGES[p], n) for p in names],
                    axis=1).astype(np.float32)


def _row_rel(port, ref):
    port, ref = port.numpy(), np.asarray(ref)
    return float((np.abs(port - ref).max(axis=1)
                  / np.abs(ref).max(axis=1)).max())


def test_composite_matches_jax():
    """Composite photometry (each component on its own route) and the
    summed spectra, port against JAX; the photometry is the sum of the
    components' own."""
    jc, tc = _composite(jst), _composite(tt)
    assert tc.param_names == jc.param_names
    assert tc.param_names[0] == "redshift" and tc.n_params == 12
    theta = _theta(tc.param_names)
    phot = tc.photometry(theta)
    assert _row_rel(phot, jax.jit(jc.photometry)(theta)) < 1e-4
    parts = sum(sim.photometry(tc._component_theta(torch.as_tensor(theta), c))
                for c, sim in tc.components.items())
    torch.testing.assert_close(phot, parts, rtol=0, atol=0)
    jout = jax.jit(lambda t: jc.simulate(t, want_spectra=True))(theta)
    tout = tc.simulate(theta, want_spectra=True)
    for key in ("photometry_njy", "fnu_njy", "lnu"):
        assert _row_rel(tout[key], jout[key]) < 1e-4, key


class _Jitted:
    """A JAX component whose `simulate(want_spectra=True)` is one jitted
    program (the JAX composite's `agn_fraction` calls its components
    eagerly, which compiles every operation on its own)."""

    def __init__(self, sim):
        self.grid, self.filters = sim.grid, sim.filters
        self.param_names = sim.param_names
        self._fn = jax.jit(lambda t: sim.simulate(t, want_spectra=True))

    def simulate(self, theta, want_spectra=False):
        assert want_spectra
        return self._fn(theta)


def test_agn_fraction_matches_jax():
    """The AGN share of the rest 1-30 µm luminosity, on the device; the
    grid AGN is not an `AGNSimulator`, so both packages take the
    component by name (and raise without one)."""
    jc, tc = _composite(jst), _composite(tt)
    theta = _theta(tc.param_names, n=8, seed=1)
    frac = tc.agn_fraction(theta, agn_components=("agn",))
    assert isinstance(frac, torch.Tensor) and frac.device == tc.device
    jitted = jst.CompositeSEDSimulator(
        {name: _Jitted(sim) for name, sim in jc.components.items()})
    ref = jitted.agn_fraction(theta, agn_components=("agn",))
    assert isinstance(ref, np.ndarray)
    np.testing.assert_allclose(frac.numpy(), ref, rtol=0, atol=1e-5)
    assert ((frac >= 0) & (frac <= 1)).all()
    with pytest.raises(ValueError, match="no AGN components"):
        tc.agn_fraction(theta)
    # the module-level band fraction of two given spectra
    lam = tc.components["stars"].grid.lam
    rng = np.random.default_rng(2)
    stellar, agn = rng.uniform(0.5, 2.0, (2, 3, lam.size)).astype(np.float32)
    port = tt.agn_fraction(torch.as_tensor(stellar), torch.as_tensor(agn),
                           lam)
    np.testing.assert_allclose(port.numpy(), np.asarray(jst.agn_fraction(
        stellar, agn, lam)), rtol=1e-6)


def test_composite_rejects_mixed_devices_filters_and_grids():
    """Components share a device and a `FilterSet`; spectra need one rest
    wavelength grid (photometry does not): the JAX package would add
    spectra of different grids column by column."""
    stars = _composite(tt).components["stars"]
    coarse = tt.AGNGridSimulator(
        tt.make_synthetic_agn_grid(n_u=3, n_nh=2, n_wav=256), stars.filters,
        photometry_backend="xla", device="cpu")
    mixed = tt.CompositeSEDSimulator({"stars": stars, "agn": coarse})
    theta = _theta(mixed.param_names, n=2)
    assert tuple(mixed.photometry(theta).shape) == (2, 7)
    with pytest.raises(ValueError, match="wavelength grids differ"):
        mixed.simulate(theta, want_spectra=True)
    with pytest.raises(ValueError, match="wavelength grids differ"):
        mixed.agn_fraction(theta, agn_components=("agn",))
    elsewhere = types.SimpleNamespace(filters=stars.filters,
                                      device=torch.device("meta"),
                                      param_names=("redshift", "x"))
    with pytest.raises(ValueError, match="share a device"):
        tt.CompositeSEDSimulator({"a": stars, "b": elsewhere})
    other = types.SimpleNamespace(
        filters=tt.FilterSet([tt.tophat_filter("X", 5000.0, 1000.0)]),
        device=stars.device, param_names=("redshift",))
    with pytest.raises(ValueError, match="share a FilterSet"):
        tt.CompositeSEDSimulator({"a": stars, "b": other})


def test_composite_library_generation():
    """`LibraryGenerator` on a composite, which has no window engine: the
    generator takes the dense `simulate` route (the gate's `getattr`
    fallback), passes each batch's `row_offset` on, and every row of the
    library is the composite's photometry of its θ (same route, bitwise)."""
    comp = tt.CompositeSEDSimulator(dict(_composite(tt).components))
    offsets, simulate = [], comp.simulate

    def spy(theta, want_spectra=False, row_offset=0):
        offsets.append(row_offset)
        return simulate(theta, want_spectra, row_offset)

    comp.simulate = spy
    gen = tt.LibraryGenerator(
        comp, {p: RANGES[p] for p in comp.param_names}, device="cpu")
    lib = gen.generate(48, batch_size=16, seed=3)
    assert offsets == [0, 16, 32]
    assert list(lib["parameter_names"]) == list(comp.param_names)
    assert lib["photometry"].shape == (7, 48)
    theta = torch.as_tensor(lib["parameters"].T)
    torch.testing.assert_close(torch.as_tensor(lib["photometry"].T),
                               comp.photometry(theta), rtol=0, atol=0)


def test_grid_combinations_exact():
    values = {"z": [0.5, 1.0, 2.0], "tau_v": [0.0, 0.5],
              "log10_mass": np.linspace(8.0, 11.0, 4)}
    theta, names = tt.grid_combinations(values)
    jtheta, jnames = jax_grid_comb(values)
    assert names == jnames and theta.dtype == np.float32
    np.testing.assert_array_equal(theta, jtheta)


# -- library combination: the cases of tests/test_combine.py -----------------
def _toy_library(name, param, n_per_z, zs, base_logmass=9.0, seed=0,
                 with_supp=False, n_lam=0):
    """`tests/test_combine.py`'s toy base: rows ∝ 10^base_logmass with a
    per-row signature; with `n_lam` also spectra on a wavelength grid."""
    rng = np.random.default_rng(seed)
    rows, zcol, pcol = [], [], []
    for z in zs:
        for v in rng.uniform(0.0, 1.0, n_per_z):
            rows.append([1.0 + v, 2.0 + v, 3.0 + v])
            zcol.append(z)
            pcol.append(v)
    phot = np.asarray(rows, np.float64).T * 10.0 ** base_logmass
    lib = {"photometry": phot.astype(np.float32),
           "parameters": np.stack([zcol, pcol]).astype(np.float32),
           "parameter_names": ["redshift", param],
           "filter_codes": ["F1", "F2", "F3"], "model_name": name}
    if with_supp:
        muv = np.full((1, phot.shape[1]), -20.0)
        lib["supplementary_parameters"] = np.concatenate(
            [phot[:1] * 2.0, muv]).astype(np.float32)
        lib["supplementary_parameter_names"] = ["line_flux", "m_uv"]
        lib["supplementary_parameter_units"] = ["erg/s/cm**2", "mag"]
    if n_lam:
        rng = np.random.default_rng(seed + 100)
        shape = 1.0 + rng.uniform(0, 1, (n_lam, phot.shape[1]))
        lib["spectra"] = (shape * 10.0 ** base_logmass).astype(np.float32)
        lib["wavelengths"] = np.geomspace(1e3, 1e5, n_lam)
    return lib


def _pair(seed_a, seed_b, n, zs, **kw):
    return [_toy_library("stellar", "alpha", n, zs, seed=seed_a, **kw),
            _toy_library("agn", "beta", n, zs, seed=seed_b, **kw)]


W4 = np.tile([[0.4, 0.6]], (4, 1))
COMBINE_CASES = {
    "outer_two_bases": ("outer", lambda: _pair(1, 2, 3, [0.5, 1.0]),
                        dict(log_stellar_masses=[8.0, 10.0],
                             redshifts=[0.5, 1.0],
                             combination_weights=[[0.3, 0.7], [0.5, 0.5]])),
    "outer_single_base_mass_grid": (
        "outer", lambda: _pair(0, 0, 3, [0.5])[:1],
        dict(log_stellar_masses=[8.0, 9.0, 10.0], redshifts=[0.5])),
    "outer_supplementary": (
        "outer", lambda: _pair(5, 6, 2, [1.0], with_supp=True),
        dict(log_stellar_masses=[9.0], redshifts=[1.0],
             combination_weights=[[0.5, 0.5]])),
    "outer_selective_supplementary": (
        "outer", lambda: _pair(5, 6, 2, [1.0], with_supp=True)[:1],
        dict(log_stellar_masses=[10.0], redshifts=[1.0],
             scale_supplementary=("line_flux",))),
    "outer_mass_params": (
        "outer", lambda: _pair(3, 4, 2, [1.0]),
        dict(log_stellar_masses=[10.0], redshifts=[1.0],
             combination_weights=[[0.25, 0.75]],
             mass_params=["alpha", None])),
    "outer_spectral": (
        "outer", lambda: _pair(13, 13, 3, [0.5], n_lam=16)[:1],
        dict(log_stellar_masses=[8.0, 9.0, 10.0], redshifts=[0.5],
             spectral_mode=True)),
    "matched": ("matched", lambda: _pair(9, 10, 4, [1.0]),
                dict(log_stellar_masses=np.array([8.0, 9.0, 10.0, 11.0]),
                     combination_weights=W4)),
    "matched_auto_supplementary": (
        "matched", lambda: _pair(5, 6, 2, [1.0], with_supp=True)[:1],
        dict(log_stellar_masses=10.0, scale_supplementary="auto")),
    "matched_spectral": ("matched", lambda: _pair(11, 12, 4, [1.0], n_lam=16),
                         dict(log_stellar_masses=np.array(
                             [8.0, 9.0, 10.0, 11.0]),
                             combination_weights=W4, spectral_mode=True)),
    "error_missing_redshift": ("outer", lambda: _pair(0, 0, 2, [0.5])[:1],
                               dict(log_stellar_masses=[9.0],
                                    redshifts=[2.0])),
    "error_unknown_column": (
        "outer", lambda: _pair(5, 6, 2, [1.0], with_supp=True)[:1],
        dict(log_stellar_masses=[10.0], redshifts=[1.0],
             scale_supplementary=("nope",))),
    "error_no_spectra": ("outer", lambda: _pair(0, 0, 2, [1.0])[:1],
                         dict(log_stellar_masses=[9.0], redshifts=[1.0],
                              spectral_mode=True)),
}


def _combine(pkg, kind, libs, kw):
    fns = {"port": (tt.combine_libraries, tt.combine_libraries_matched),
           "jax": (jax_combine, jax_matched)}[pkg]
    try:
        return fns[kind == "matched"](libs, **kw)
    except ValueError as e:
        return e


@pytest.mark.parametrize("case", sorted(COMBINE_CASES))
def test_combine_libraries_matches_jax(case):
    kind, make, kw = COMBINE_CASES[case]
    port = _combine("port", kind, make(), kw)
    ref = _combine("jax", kind, make(), kw)
    if isinstance(ref, ValueError):
        assert case.startswith("error_")
        assert type(port) is type(ref) and str(port) == str(ref)
        return
    assert sorted(port) == sorted(ref)
    for key, val in ref.items():
        if isinstance(val, np.ndarray):
            assert port[key].dtype == val.dtype, key
            np.testing.assert_array_equal(port[key], val, err_msg=key)
        else:
            assert port[key] == val, key


def test_combined_library_hdf5_across_packages(tmp_path):
    """A combined library written by the port's `save_library_hdf5` reads
    back in both packages and feeds the port's fitter."""
    libs = _pair(7, 8, 3, [0.5, 1.0])
    path = str(tmp_path / "combined.h5")
    out = tt.combine_libraries(libs, [8.0, 10.0], [0.5, 1.0], [[0.3, 0.7]],
                               out_path=path)
    for lib in (tt.load_library_hdf5(path), jax_load_library(path)):
        assert lib["parameter_names"] == out["parameter_names"]
        np.testing.assert_array_equal(lib["photometry"], out["photometry"])
        np.testing.assert_array_equal(lib["parameters"], out["parameters"])
    fitter = tt.SBIFitter.init_from_hdf5(path, device="cpu")
    assert fitter.photometry.shape == (out["photometry"].shape[1], 3)
    assert fitter.parameters.shape[1] == 5
