"""Port parity, the AGN forward models: `AGNSimulator` (analytic disk +
torus), `AGNGridSimulator` (disk incident + NLR/BLR tables) and
`make_synthetic_agn_grid` against the JAX package on the same numpy-seeded
θ, and the gate that keeps both simulators off the stellar kernels.

Setup: the 32×5×512 test grid for the analytic model, a 3 × 2 × 512 AGN
grid (n_u, n_nh, n_wav), 7 tophat bands, Inoue14 IGM; both photometry
backends ("xla", the exact route; "pallas", the plain knot route that the
card takes for these simulators).

Tolerances, on values above 1e-3 of their row's maximum:
- photometry, f_ν and L_ν from θ: max relative difference < 1e-5 (the
  AGN models have no SFH CDF differences; measured ≤ 4.1e-6);
- line luminosities, fluxes and EWs: < 1e-5 (measured 3.6e-7);
- the grid builder: bitwise equal (the same numpy code);
- the bolometric normalisation ∫ L_ν dν = 10**log10_l_agn: 0.05 dex (the
  JAX test's bound: the disk window and the torus are integrated on the
  grid, the trapezoid here).
"""

import functools

import h5py
import jax
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu.library import LibraryGenerator as JaxLibraryGenerator
from synference_tpu.library import \
    simulator_from_library as jax_simulator_from_library

_CODES = ["F090W", "F115W", "F150W", "F200W", "F277W", "F356W", "F444W"]
_CENTERS = [9000., 11500., 15000., 20000., 27700., 35600., 44400.]
_WIDTHS = [2000., 2600., 3300., 4600., 7000., 7800., 10200.]
AGN_PRIOR = {"log10_l_agn": (44.0, 47.0), "redshift": (0.1, 6.0),
             "ionisation_parameter": (-3.0, 0.0),
             "hydrogen_density": (2.0, 6.0),
             "covering_fraction_blr": (0.0, 0.3),
             "covering_fraction_nlr": (0.0, 0.5), "tau_v": (0.0, 1.5)}
TORUS = ("log10_l_agn", "redshift", "agn_slope", "tau_v", "torus_fraction",
         "torus_temperature")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _filters(pkg):
    return pkg.FilterSet([pkg.tophat_filter(c, ct, w) for c, ct, w in
                          zip(_CODES, _CENTERS, _WIDTHS)])


def _kw(pkg, **kw):
    return dict(kw, device="cpu") if pkg is tt else kw


@functools.lru_cache(maxsize=None)
def _agn_grid(pkg):
    return pkg.make_synthetic_agn_grid(n_u=3, n_nh=2, n_wav=512)


@functools.lru_cache(maxsize=None)
def _analytic(pkg, backend, names=None):
    grid = pkg.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0)
    kw = _kw(pkg, photometry_backend=backend)
    if names is not None:
        kw["param_names"] = names
    return pkg.AGNSimulator(grid, _filters(pkg), **kw)


@functools.lru_cache(maxsize=None)
def _gridded(pkg, backend, regions=None):
    kw = _kw(pkg, photometry_backend=backend)
    if regions is not None:
        kw["emission"] = pkg.EmissionConfig(
            incident_type="incident", reprocessed_types=regions, fesc=0.0)
    return pkg.AGNGridSimulator(_agn_grid(pkg), _filters(pkg), **kw)


def _analytic_theta(names, n=16, seed=0):
    rng = np.random.default_rng(seed)
    cols = {"log10_l_agn": rng.uniform(43.0, 46.5, n),
            "redshift": rng.uniform(0.2, 5.0, n),
            "agn_slope": rng.uniform(-1.2, 0.3, n),
            "tau_v": rng.uniform(0.0, 1.0, n),
            "torus_fraction": rng.uniform(0.0, 0.9, n),
            "torus_temperature": rng.uniform(150.0, 1200.0, n)}
    return np.stack([cols[p] for p in names], axis=1).astype(np.float32)


def _grid_theta(names, n=16, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(*AGN_PRIOR[p], n) for p in names],
                    axis=1).astype(np.float32)


def _rel(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    sig = ref > 1e-3 * ref.max(axis=1, keepdims=True)
    return float((np.abs(port - ref)[sig] / ref[sig]).max())


def _match(jsim, tsim, theta, jit=True):
    """Photometry and the want_spectra outputs, port against JAX (jitted
    unless `jit` is False: one compile each instead of one per
    operation)."""
    wrap = jax.jit if jit else (lambda fn: fn)
    jphot = wrap(jsim.photometry)(theta)
    assert _rel(tsim.photometry(theta), jphot) < TOL
    jout = wrap(lambda t: jsim.simulate(t, want_spectra=True))(theta)
    tout = tsim.simulate(torch.as_tensor(theta), want_spectra=True)
    for key in ("photometry_njy", "fnu_njy", "lnu", "lnu_intrinsic"):
        assert _rel(tout[key], jout[key]) < TOL, key
    for key in ("sfh_mass", "sfzh"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=TOL, atol=0.0)


@pytest.mark.parametrize("names, backend", [(None, "xla"),
                                            (TORUS, "pallas")],
                         ids=["default-xla", "torus-pallas"])
def test_analytic_agn_matches_jax(names, backend):
    """The analytic model, its default θ and with a per-row torus fraction
    and temperature (a greybody per row). The JAX side runs eagerly: under
    `jax.jit` on the CPU its L_ν is inf in every entry (XLA reassociates
    the two 1e15 factors that keep the 1e30 scale inside float32), a fault
    of the reference recorded in ROADMAP queue 3 and checked here."""
    jsim, tsim = _analytic(jst, backend, names), _analytic(tt, backend, names)
    assert tsim.param_names == jsim.param_names
    theta = _analytic_theta(tsim.param_names)
    _match(jsim, tsim, theta, jit=False)
    if names is None:
        lnu = jax.jit(jax.vmap(lambda r: jsim._agn_lnu(jsim.theta_dict(r))))
        assert np.isinf(np.asarray(lnu(theta))).all()
        params = tsim.theta_dict(torch.as_tensor(theta))
        assert torch.isfinite(tsim._agn_lnu(params)).all()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_grid_agn_matches_jax(backend):
    jsim, tsim = _gridded(jst, backend), _gridded(tt, backend)
    assert tsim.param_names == jsim.param_names == (
        "log10_l_agn", "redshift", "ionisation_parameter",
        "hydrogen_density", "covering_fraction_blr",
        "covering_fraction_nlr", "tau_v")
    theta = _grid_theta(tsim.param_names)
    _match(jsim, tsim, theta)
    jlq, tlq = jsim.line_quantities(theta), tsim.line_quantities(theta)
    assert tlq["ids"] == list(jlq["ids"])
    for key in ("luminosity", "flux", "ew_rest", "ew_obs"):
        assert _rel(tlq[key], jlq[key]) < TOL, key


def test_bolometric_normalisation():
    """∫ L_ν dν of the analytic model is 10**log10_l_agn: the 1e30 scale,
    carried as two factors, survives float32."""
    sim = _analytic(tt, "xla")
    lnu = sim.simulate(torch.tensor([[45.0, 1.0, -0.5, 0.0]]),
                       want_spectra=True)["lnu"][0].double().numpy()
    assert np.isfinite(lnu).all()
    nu = 2.99792458e18 / np.asarray(sim.grid.lam, np.float64)
    lbol = np.trapezoid(lnu[::-1], nu[::-1])
    assert abs(np.log10(lbol) - 45.0) < 0.05


def test_line_mixing_with_an_unmodelled_region():
    """An NLR-only model: BLR-tagged lines take covering fraction 0 through
    the zero column, NLR lines stay positive, as in the JAX package."""
    jsim = _gridded(jst, "xla", ("nlr",))
    tsim = _gridded(tt, "xla", ("nlr",))
    theta = _grid_theta(tsim.param_names, n=4)
    tlq, jlq = tsim.line_quantities(theta), jsim.line_quantities(theta)
    regions = _agn_grid(tt).lines["region"]
    blr = np.asarray([r == "blr" for r in regions])
    assert (tlq["luminosity"][:, blr] == 0.0).all()
    assert (tlq["luminosity"][:, ~blr] > 0.0).all()
    assert _rel(tlq["luminosity"][:, ~blr], jlq["luminosity"][:, ~blr]) < TOL


def test_grid_builder_matches_jax():
    jg, tg = _agn_grid(jst), _agn_grid(tt)
    assert tg.extra_axis_names == jg.extra_axis_names
    for t in ("incident", "nlr", "blr"):
        np.testing.assert_array_equal(tg.spectra[t], jg.spectra[t])
    for k in ("luminosity", "continuum", "wavelength"):
        assert tg.lines[k].dtype == np.float64
        np.testing.assert_array_equal(tg.lines[k], jg.lines[k])
    assert list(tg.lines["region"]) == list(jg.lines["region"])
    assert tg.lines["luminosity"].max() > 1e40  # beyond float32's 3.4e38
    np.testing.assert_array_equal(tg.lam, jg.lam)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_agn_grid_hdf5_round_trip(writer, tmp_path):
    """The AGN grid written by either package reads back in the other with
    its region tags and float64 line luminosities."""
    path = str(tmp_path / "agn_grid.h5")
    (_agn_grid(tt) if writer == "port" else _agn_grid(jst)).to_hdf5(path)
    for pkg in (tt, jst):
        g2 = pkg.SPSGrid.from_hdf5(path)
        ref = _agn_grid(pkg)
        assert g2.extra_axis_names == ("ionisation_parameter",
                                       "hydrogen_density")
        assert list(g2.lines["region"]) == list(ref.lines["region"])
        np.testing.assert_array_equal(g2.lines["luminosity"],
                                      ref.lines["luminosity"])
        for t in ("incident", "nlr", "blr"):
            np.testing.assert_array_equal(g2.spectra[t], ref.spectra[t])


def test_library_round_trip_across_packages(tmp_path):
    """A port AGN library rebuilds an `AGNGridSimulator` with its `l_norm`
    in both packages (the registry; `simulator_extra`), and a JAX AGN
    library rebuilds one in the port; the rebuilt simulators reproduce the
    stored photometry."""
    tsim = tt.AGNGridSimulator(_agn_grid(tt), _filters(tt), l_norm=44.0,
                               device="cpu")
    path = str(tmp_path / "port_agn.h5")
    lib = tt.LibraryGenerator(tsim, AGN_PRIOR, device="cpu").generate(
        n=32, batch_size=32, seed=7, out_path=path)
    theta = lib["parameters"].T
    rebuilt = tt.simulator_from_library(path, grid=_agn_grid(tt),
                                        device="cpu")
    assert type(rebuilt) is tt.AGNGridSimulator
    assert rebuilt._log10_l_norm == 44.0
    np.testing.assert_allclose(rebuilt.photometry(theta).numpy(),
                               lib["photometry"].T, rtol=1e-6)
    jrebuilt = jax_simulator_from_library(path, grid=_agn_grid(jst))
    assert type(jrebuilt) is jst.AGNGridSimulator
    assert jrebuilt._log10_l_norm == 44.0

    jpath = str(tmp_path / "jax_agn.h5")
    JaxLibraryGenerator(_gridded(jst, "xla"), AGN_PRIOR).generate(
        n=8, batch_size=8, seed=3, out_path=jpath)
    from_jax = tt.simulator_from_library(jpath, grid=_agn_grid(tt),
                                         device="cpu")
    assert type(from_jax) is tt.AGNGridSimulator
    assert from_jax._log10_l_norm == 45.0


def test_analytic_library_rebuilds(tmp_path):
    """A library of the analytic model rebuilds an `AGNSimulator` with its
    θ names, which reproduces the stored photometry."""
    sim = _analytic(tt, "xla", TORUS)
    path = str(tmp_path / "analytic.h5")
    lib = tt.LibraryGenerator(sim, {
        "log10_l_agn": (44.0, 46.0), "redshift": (0.1, 6.0),
        "agn_slope": (-1.0, 0.0), "tau_v": (0.0, 1.0),
        "torus_fraction": (0.1, 0.6), "torus_temperature": (200.0, 900.0)},
        device="cpu").generate(n=16, batch_size=16, out_path=path)
    rebuilt = tt.simulator_from_library(path, grid=sim.grid, device="cpu")
    assert type(rebuilt) is tt.AGNSimulator
    assert rebuilt.param_names == TORUS
    np.testing.assert_array_equal(
        rebuilt.photometry(lib["parameters"].T).numpy(), lib["photometry"].T)


def test_embedded_agn_library_rebuilds(tmp_path):
    """An AGN library with its grid embedded rebuilds in the port. The JAX
    reader passes the embedded grid's axes on as constructor arguments
    (`simulator_extra` and the axes share one name there) and raises
    TypeError: a fault of the reference, recorded in ROADMAP queue 3."""
    path = str(tmp_path / "embedded.h5")
    tt.LibraryGenerator(_gridded(tt, "xla"), AGN_PRIOR, embed_grid=True,
                        device="cpu").generate(n=8, batch_size=8,
                                               out_path=path)
    sim = tt.simulator_from_library(path, device="cpu")
    assert type(sim) is tt.AGNGridSimulator
    assert sim.grid.extra_axis_names == _agn_grid(tt).extra_axis_names
    with pytest.raises(TypeError, match="ionisation_parameter"):
        jax_simulator_from_library(path)


def test_unregistered_class_raises(tmp_path):
    """No silent fallback: a class name outside `SIMULATOR_REGISTRY`
    raises ValueError (the JAX package builds `BatchSEDSimulator`)."""
    path = str(tmp_path / "lib.h5")
    tt.LibraryGenerator(_gridded(tt, "xla"), AGN_PRIOR,
                        device="cpu").generate(n=8, batch_size=8,
                                               out_path=path)
    with h5py.File(path, "a") as f:
        f["Model"].attrs["simulator_class"] = "QuasarSimulator"
    with pytest.raises(ValueError, match="QuasarSimulator"):
        tt.simulator_from_library(path, grid=_agn_grid(tt), device="cpu")
    assert {"BatchSEDSimulator", "AGNSimulator", "AGNGridSimulator"} <= set(
        tt.sed.SIMULATOR_REGISTRY)


def test_gate_keeps_agn_off_the_kernels():
    """A subclass with its own `_core` or `_apply_emission` never reaches K1,
    K2 or the staged window body: on the pallas backend, where a stellar
    simulator of the same grid passes every gate, both AGN simulators fail
    them, and their libraries take the host path and the dense route."""
    stellar = tt.BatchSEDSimulator(
        _analytic(tt, "pallas").grid, _filters(tt),
        ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
         "tau_v"), photometry_backend="pallas", device="cpu")
    assert stellar._mega_supported() and stellar._window_supported()
    for sim in (_analytic(tt, "pallas"), _gridded(tt, "pallas")):
        assert sim._overrides_forward_model()
        assert sim._mega_supported() is False
        assert sim._window_supported() is False
        assert sim._window_mega_supported() is False
        with pytest.raises(ValueError, match="device_sampling"):
            tt.LibraryGenerator(sim, AGN_PRIOR if isinstance(
                sim, tt.AGNGridSimulator) else {
                    "log10_l_agn": (44.0, 46.0), "redshift": (0.1, 6.0),
                    "agn_slope": (-1.0, 0.0), "tau_v": (0.0, 1.0)},
                device="cpu").generate(n=8, device_sampling=True)
        with pytest.raises(ValueError, match="window engine"):
            sim.photometry_zsorted_device(torch.zeros(4, sim.n_params))


def test_fused_core_returns_trimmed_support():
    """`_core(fused=True)` of the analytic model returns the λ support, and
    the plain knot route agrees with the exact route (the JAX test's
    bound: p99 < 2e-2)."""
    fused, exact = _analytic(tt, "pallas"), _analytic(tt, "xla")
    assert fused._lam_support is not None
    theta = torch.as_tensor(_analytic_theta(fused.param_names))
    out = fused._core(theta, want_spectra=False, fused=True)
    l0, l1 = fused._lam_support
    assert tuple(out["_lnu"].shape) == (theta.shape[0], l1 - l0)
    p_fused, p_exact = fused.photometry(theta), exact.photometry(theta)
    sig = p_exact > 1e-3 * p_exact.amax(dim=1, keepdim=True)
    rel = ((p_fused - p_exact).abs()[sig] / p_exact[sig]).numpy()
    assert np.quantile(rel, 0.99) < 2e-2
