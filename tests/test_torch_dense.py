"""Port parity, the dense simulator path: the port's `simulate()` /
`photometry()` on θ in any order against the JAX package's, on the same
θ and, where stated, on the same tables (`load_state`).

Setup: the 32×5×512 test grid, 7 tophat bands, lognormal SFH, delta Z,
Calzetti screen, Inoue14 IGM; emission cases as `tests/test_sed.py`:
the default screen, Pacman channels with fesc as a θ column and a
birth-cloud screen, and greybody dust emission.

Tolerances, on values above 1e-3 of their row's maximum unless said:
- fp32 paths on identical inputs (`_apply_emission` given the same SFZH,
  `_observe` given the same L_ν, `_photometry_one` given the same f_ν): max
  relative difference < 1e-5.
- fp32 paths end to end from θ: |Δ| < 1e-4 of the row's largest value.
  The SFZH bin masses are differences of lognormal CDF values that erf and
  log in the two packages round one float32 ulp apart (6e-8 near 0.27), so
  a small bin differs by up to ~1e-3 relative (measured: 8.7e-4 on a bin of
  2e-4) and the SFZH by 2.2e-5 of its row maximum; dust emission carries
  that into f_ν through the absorbed energy (2.2e-5). Elsewhere measured
  ≤ 3.1e-6.
- the IGM table: |Δ| < 1e-5 of the row's largest value (measured 9.5e-7;
  near the Lyman limit T = exp(−τ) with τ up to ~7 amplifies an ulp of τ).
- knot-interpolated paths (bf16 knot product): median < 2e-3, p99 < 5e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu.recovery import recover_sed as jax_recover_sed

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
_CODES = ["F090W", "F115W", "F150W", "F200W", "F277W", "F356W", "F444W"]
_CENTERS = [9000., 11500., 15000., 20000., 27700., 35600., 44400.]
_WIDTHS = [2000., 2600., 3300., 4600., 7000., 7800., 10200.]

# emission cases: (EmissionConfig kwargs, extra θ columns and their values)
CASES = {
    "screen": (dict(), ()),
    "pacman_birth_cloud": (dict(
        incident_type="incident", reprocessed_types=("transmitted", "nebular"),
        fesc="fesc", tau_v_bc_param="tau_v_bc", age_pivot_log10=7.0),
        (("fesc", 0.0, 0.4), ("tau_v_bc", 0.0, 1.5))),
    "dust_emission": (dict(dust_emission=True, dust_temperature=40.0), ()),
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


def _sim(pkg, case="screen", **kw):
    em_kw, extra = CASES[case]
    names = PNAMES + tuple(e[0] for e in extra)
    grid = pkg.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0)
    filt = pkg.FilterSet([pkg.tophat_filter(c, ct, w) for c, ct, w in
                          zip(_CODES, _CENTERS, _WIDTHS)])
    if pkg is tt:
        kw = dict(kw, device="cpu")
    return pkg.BatchSEDSimulator(grid, filt, names, sfh="lognormal",
                                 zdist="delta",
                                 emission=pkg.EmissionConfig(**em_kw), **kw)


@functools.lru_cache(maxsize=None)
def _pair(case="screen", backend="pallas"):
    """(JAX simulator, port simulator with the JAX tables loaded), built
    once per module; the interp variant on the pallas backend."""
    kw = dict(photometry_backend=backend)
    if backend == "pallas":
        kw["photometry_variant"] = "interp"
    jsim, tsim = _sim(jst, case, **kw), _sim(tt, case, **kw)
    tsim.load_state(_jax_state(jsim))
    return jsim, tsim


def _theta(n, case="screen", seed=0):
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(8, 11, n), rng.uniform(0.05, 8, n),
            rng.uniform(1e8, 1e9, n), rng.uniform(.1, 1.2, n),
            rng.uniform(-3.5, -2, n), rng.uniform(0, 2, n)]
    cols += [rng.uniform(lo, hi, n) for _, lo, hi in CASES[case][1]]
    return np.column_stack(cols).astype(np.float32)


def _jax_state(jsim):
    """The JAX simulator's tables that the dense path reads, as numpy."""
    state = {
        "age_table": np.asarray(jsim._age_table),
        "d19_table": np.asarray(jsim._d19_table),
        "components": {k: np.asarray(v) for k, v in jsim._components.items()},
        "dust_curve": np.asarray(jsim._dust_curve),
        "wlam": np.asarray(jsim._wlam),
        "filter_table": np.asarray(jsim._filter_table),
        "igm_table": np.asarray(jsim._igm_table),
    }
    if jsim.photometry_backend == "pallas":
        t_mix, m_igm, den_knots = jsim._zsorted_tables()
        state.update(
            knot_matrix=np.asarray(jsim._pallas_table[0]),
            m_igm=np.asarray(m_igm), t_mix=np.asarray(t_mix),
            den_knots=np.asarray(den_knots),
            den_table=np.asarray(jsim._den_table),
            dust_curve_sup=np.asarray(jsim._dust_curve_sup),
            wlam_sup=np.asarray(jsim._wlam_sup))
    return state


def _rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    rel = np.abs(port - ref) / np.maximum(np.abs(ref), 1e-30)
    return rel[np.abs(ref) > 1e-3 * np.abs(ref).max(axis=-1, keepdims=True)]


def _row_rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    return float((np.abs(port - ref)
                  / np.abs(ref).max(axis=-1, keepdims=True)).max())


def _assert_knot_close(port, ref):
    rel = _rel(port, ref)
    assert np.median(rel) < 2e-3, np.median(rel)
    assert np.quantile(rel, 0.99) < 5e-3, np.quantile(rel, 0.99)


@pytest.fixture(scope="module")
def exact_runs():
    """Per emission case: both simulators on the exact route with the JAX
    tables loaded into the port, and both spectra outputs."""
    runs = {}
    for case in CASES:
        jsim, tsim = _pair(case, backend="xla")
        theta = _theta(16, case, seed=1)
        runs[case] = (jsim, tsim, theta,
                      jsim.simulate(jnp.asarray(theta), want_spectra=True),
                      tsim.simulate(theta, want_spectra=True))
    return runs


def test_igm_table_matches_jax(exact_runs):
    jsim = exact_runs["screen"][0]
    own = _sim(tt)._igm_table
    assert own.shape == (512, 512)
    assert _row_rel(own.numpy(), jsim._igm_table) < 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_emission_on_identical_inputs(exact_runs, case):
    """`_apply_emission` on the JAX run's own SFZH: L_ν and intrinsic L_ν."""
    _, tsim, theta, jout, _ = exact_runs[case]
    params = tsim.theta_dict(torch.as_tensor(theta))
    lnu, intrinsic = tsim._apply_emission(
        params, torch.tensor(np.asarray(jout["sfzh"])))
    assert _rel(lnu, jout["lnu"]).max() < 1e-5
    assert _rel(intrinsic, jout["lnu_intrinsic"]).max() < 1e-5


def test_observe_and_photometry_one_on_identical_inputs(exact_runs):
    _, tsim, theta, jout, _ = exact_runs["screen"]
    params = tsim.theta_dict(torch.as_tensor(theta))
    fnu = tsim._observe(params, torch.tensor(np.asarray(jout["lnu"])))
    assert _rel(fnu, jout["fnu_njy"]).max() < 1e-5
    phot = tsim._photometry_one(torch.tensor(np.asarray(jout["fnu_njy"])),
                                params["redshift"])
    assert _rel(phot, jout["photometry_njy"]).max() < 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_exact_path_end_to_end(exact_runs, case):
    _, _, _, jout, tout = exact_runs[case]
    assert set(tout) == set(jout)
    for key in ("photometry_njy", "fnu_njy", "lnu", "lnu_intrinsic", "sfzh",
                "sfh_mass"):
        assert _row_rel(tout[key], jout[key]) < 1e-4, key


def test_interp_spectra_route_matches_jax():
    """want_spectra on the pallas interp backend integrates f_ν against the
    plain knot matrix (`_photometry_batch`)."""
    jsim, tsim = _pair()
    theta = _theta(16, seed=2)
    ref = jsim.simulate(jnp.asarray(theta), want_spectra=True)
    out = tsim.simulate(theta, want_spectra=True)
    _assert_knot_close(out["photometry_njy"], ref["photometry_njy"])
    assert _row_rel(out["fnu_njy"], ref["fnu_njy"]) < 1e-4


def test_photometry_fused_on_identical_inputs():
    """The plain full-table route on the JAX run's own support L_ν."""
    jsim, tsim = _pair()
    theta = _theta(16, seed=3)
    lnu = np.asarray(jax.vmap(
        lambda row: jsim._core(row, False, fused=True)["_lnu"])(
            jnp.asarray(theta)))
    z = theta[:, 1]
    ref = jsim._photometry_fused(jnp.asarray(lnu), jnp.asarray(z))
    out = tsim._photometry_fused(torch.tensor(lnu), torch.tensor(z))
    _assert_knot_close(out, ref)


@pytest.mark.parametrize("case", ["pacman_birth_cloud", "dust_emission"])
def test_dense_photometry_outside_window_envelope(case):
    """Emission models the window engine and K2 refuse take the plain
    full-table route (`_photometry_fused`) on the pallas backend."""
    jsim, tsim = _pair(case)
    assert not tsim._mega_supported() and not jsim._mega_supported()
    theta = _theta(16, case, seed=4)
    _assert_knot_close(tsim.photometry(theta),
                       jsim.photometry(jnp.asarray(theta)))


def test_whole_table_window_takes_dense_path():
    """A sub-chunk whose window is the whole table goes to `photometry()`,
    in the port as in the JAX package."""
    jsim, tsim = _pair()
    theta = _theta(64, seed=5)
    theta = theta[np.argsort(theta[:, 1])]
    _, _, kc, w_cols, k0, _ = tsim._plan_windows(theta, 64)
    assert k0 is None and (kc >= tsim._n_knots or w_cols >= tsim._l_sup)
    out = tsim.photometry_zsorted_device(theta, sub_chunk=64)
    np.testing.assert_array_equal(out.numpy(), tsim.photometry(theta).numpy())
    ref = jsim.photometry_zsorted_device(jnp.asarray(theta), sub_chunk=64)
    _assert_knot_close(out, ref)


def test_backend_and_variant_selection():
    sim = _sim(tt)
    assert sim.photometry_backend == "xla" and sim._variant == "interp"
    assert sim(_theta(4)).shape == (4, len(_CODES))
    np.testing.assert_array_equal(sim(_theta(4)).numpy(),
                                  sim.photometry(_theta(4)).numpy())
    assert (sim.n_filters, sim.n_params) == (len(_CODES), len(PNAMES))
    # "auto" keeps interp whatever the knot matrix's size (the JAX
    # package's 64 MiB switch to conv serves its TPU compile cap only)
    assert sim._pick_variant("auto") == "interp"
    for bad in (dict(photometry_backend="tpu"),
                dict(photometry_variant="exact")):
        with pytest.raises(ValueError, match="unknown photometry"):
            tt.BatchSEDSimulator(sim.grid, sim.filters, PNAMES, device="cpu",
                                 **bad)


def test_mega_gate():
    """K2's static gate: the JAX envelope and no λ-count gate; nothing
    about a launch."""
    xla = _sim(tt)
    pallas = _sim(tt, photometry_backend="pallas")
    assert not xla._mega_supported() and pallas._mega_supported()
    assert pallas._n_knots >= 4
    for case in ("pacman_birth_cloud", "dust_emission"):
        assert not _sim(tt, case, photometry_backend="pallas")._mega_supported()
    for kw in (dict(photometry_interp_order=2),
               dict(photometry_variant="roll")):
        assert not _sim(tt, photometry_backend="pallas", **kw)._mega_supported()
    sim = tt.BatchSEDSimulator(
        pallas.grid, pallas.filters, PNAMES, device="cpu",
        photometry_backend="pallas",
        emission=tt.EmissionConfig(fesc=0.2, reprocessed_types=("total",)))
    assert not sim._mega_supported()


def test_recover_sed_matches_jax(exact_runs):
    jsim, tsim, _, _, _ = exact_runs["screen"]
    rng = np.random.default_rng(6)
    samples = np.column_stack([
        rng.normal(9.5, 0.1, 40), rng.normal(2.0, 0.05, 40),
        rng.uniform(2e8, 4e8, 40), rng.uniform(.4, .6, 40),
        rng.uniform(-2.6, -2.4, 40), rng.uniform(.2, .4, 40)]).astype(
            np.float32)
    port = tt.recover_sed(tsim, samples, max_draws=32)
    ref = jax_recover_sed(jsim, samples, max_draws=32)
    assert set(port) == set(ref)
    np.testing.assert_allclose(port["lam"], ref["lam"], rtol=1e-6)
    for key in ("fnu_quantiles", "photometry_quantiles", "sfh_quantiles"):
        assert _row_rel(port[key], ref[key]) < 1e-4, key
    with pytest.raises(ValueError, match="samples must be"):
        tt.recover_sed(tsim, samples[0])


def test_load_state_checks():
    tsim = _sim(tt)
    with pytest.raises(ValueError, match="holds no 'subshift_table'"):
        tsim.load_state({"subshift_table": np.zeros((8, 8, 10), np.float32)})
    with pytest.raises(ValueError, match="components"):
        tsim.load_state({"components": {"total": np.zeros((160, 512))}})
    with pytest.raises(ValueError, match="shape"):
        tsim.load_state({"igm_table": np.zeros((3, 3), np.float32)})
