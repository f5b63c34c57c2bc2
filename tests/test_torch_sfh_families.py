"""Port parity, the SFH and metallicity families beyond lognormal/delta:
the port's `sfh_weights` / `zdist_weights` against the JAX package's (vmapped
over the batch) and a float64 numpy oracle of each closed-form CDF, then the
simulator end to end with each family.

Tolerances:
- per-bin weights on rows summing to 1: max |Δ| ≤ 5e-6 against the JAX
  package (measured: delayed-τ 2.9e-6 on a bin of 0.11, where the
  1 − (1 + r)e^{−r} cancellation meets the two packages' expm1, and there
  the port lies 4.9e-7 from the float64 oracle; every other family
  ≤ 2.4e-7; dense-basis 3.0e-6 on a bin of 0.27, from its float32
  10^x bin edges; normal Z ≤ 2e-6); ≤ 2e-5 against the float64 oracle (measured ≤ 6.3e-6), except
  the double power law, whose 512-node trapezoid cumulative (the JAX
  package's method) lies 8.3e-4 from an adaptive quadrature: 2e-3;
- end-to-end photometry on the exact ("xla") route, the JAX tables loaded:
  |Δ| < 1e-4 of the row's largest band (`tests/test_torch_dense.py`'s
  rule for CDF-difference bins; measured ≤ 3e-6);
- every family on a flat-L_ν grid against the closed form of
  `tests/test_analytic_physics.py` (rtol 2e-3, its bound), and the
  lognormal port against `tests/test_grid_parity.py`'s float64 oracle at
  that test's bound (median < 0.5 %, max < 2 %).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import quad
from scipy.special import ndtr

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu import sfh as jsfh
from synference_tpu_torch import sfh as tsfh

from test_torch_dense import _jax_state

_CODES = ["F090W", "F150W", "F200W", "F356W", "F444W"]
_CENTERS = [9000., 15000., 20000., 35600., 44400.]
_WIDTHS = [2000., 3300., 4600., 7800., 10200.]
# family -> (θ names after log10_mass, redshift; sampler of their values)
FAMILIES = {
    "constant": (("min_age",), lambda r, n: [r.uniform(1e6, 5e7, n)]),
    "delayed_tau": (("tau",), lambda r, n: [r.uniform(5e7, 3e9, n)]),
    "exponential": (("tau",), lambda r, n: [r.uniform(5e7, 3e9, n)]),
    "rising_exponential": (("tau",), lambda r, n: [r.uniform(5e7, 3e9, n)]),
    "gaussian_burst": (("burst_age", "sigma"),
                       lambda r, n: [r.uniform(5e6, 8e8, n),
                                     r.uniform(5e5, 5e7, n)]),
    "double_power_law": (("peak_age", "alpha", "beta"),
                         lambda r, n: [r.uniform(1e8, 2e9, n),
                                       r.uniform(0.5, 6, n),
                                       r.uniform(0.5, 6, n)]),
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


def _grid(pkg):
    return pkg.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0)


def _params(family, n, seed=0):
    rng = np.random.default_rng(seed)
    names, draw = FAMILIES[family]
    p = dict(zip(names, draw(rng, n)))
    p["max_age"] = rng.uniform(2e8, 1.3e10, n)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _edges():
    return jst.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512,
                                   seed=0).age_bin_edges_yr


def _jax_weights(name, p, edges):
    samp = jsfh.make_age_sampling(edges)
    return np.asarray(jax.vmap(lambda d: jsfh.sfh_weights(name, d, samp))(
        {k: jnp.asarray(v) for k, v in p.items()}))


def _port_weights(name, p, edges):
    samp = tsfh.make_age_sampling(edges, "cpu")
    return tsfh.sfh_weights(
        name, {k: torch.as_tensor(v) for k, v in p.items()}, samp).numpy()


def _oracle_cdf(name, p, x):
    """float64 cumulative mass of each family at x = max_age − t."""
    if name == "constant":
        return np.clip(x, 0.0, np.maximum(p["max_age"] - p["min_age"], 1.0))
    if name in ("delayed_tau", "exponential"):
        r = np.maximum(x, 0.0) / np.maximum(p["tau"], 1e4)
        return (-np.expm1(-r) - (r * np.exp(-r) if name == "delayed_tau"
                                 else 0.0))
    if name == "rising_exponential":
        return np.exp((np.minimum(x, p["max_age"]) - p["max_age"])
                      / np.maximum(p["tau"], 1e4))
    if name == "gaussian_burst":
        return ndtr((x - (p["max_age"] - p["burst_age"]))
                    / np.maximum(p["sigma"], 1e4))
    # double power law: quadrature of the SFR from 1 yr
    x0, a, b = max(p["peak_age"], 1e4), p["alpha"], p["beta"]

    def pdf(t):
        r = max(t, 1.0) / x0
        return 1.0 / (r**a + r**-b)

    xs = np.clip(x, 1.0, max(p["max_age"], 10.0))
    return np.array([quad(pdf, 1.0, xi, limit=200, points=[x0])[0]
                     if xi > 1.0 else 0.0 for xi in xs])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_weights_match_jax_and_oracle(family):
    edges = _edges()
    p = _params(family, 64)
    port = _port_weights(family, p, edges)
    ref = _jax_weights(family, p, edges)
    assert port.shape == ref.shape == (64, len(edges) - 1)
    np.testing.assert_allclose(port.sum(1), 1.0, rtol=2e-6)
    assert np.abs(port - ref).max() <= 5e-6
    atol = 2e-3 if family == "double_power_law" else 2e-5
    for i in range(0, 64, 8):  # float64 oracle on every eighth row
        pi = {k: float(v[i]) for k, v in p.items()}
        m = _oracle_cdf(family, pi, np.clip(pi["max_age"] - edges, 0, None))
        w = np.maximum(m[:-1] - m[1:], 0.0)
        np.testing.assert_allclose(port[i], w / w.sum(), rtol=0, atol=atol)


def test_interp_clamped_matches_jnp_interp():
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(0, 10, (4, 32)), axis=1).astype(np.float32)
    xp[:, 5] = xp[:, 4]  # a zero-width interval: jnp.interp's dx0 branch
    fp = rng.normal(size=(4, 32)).astype(np.float32)
    x = rng.uniform(-2, 12, (4, 50)).astype(np.float32)
    port = tsfh._interp_clamped(torch.as_tensor(x), torch.as_tensor(xp),
                                torch.as_tensor(fp)).numpy()
    ref = np.stack([np.asarray(jnp.interp(x[i], xp[i], fp[i]))
                    for i in range(4)])
    np.testing.assert_allclose(port, ref, rtol=0, atol=2e-6)


def test_dense_basis_and_normal_z():
    edges = _edges()
    rng = np.random.default_rng(1)
    fr = rng.dirichlet(np.ones(6), 16).astype(np.float32)
    p = {"fractions": fr, "max_age": rng.uniform(5e8, 1.2e10, 16).astype(
        np.float32), "min_age": np.full(16, 1e7, np.float32)}
    port = _port_weights("dense_basis", p, edges)
    ref = _jax_weights("dense_basis", p, edges)
    assert np.abs(port - ref).max() <= 5e-6
    # fractions shared by the batch (a fixed parameter) broadcast
    shared = _port_weights("dense_basis", dict(p, fractions=fr[0]), edges)
    np.testing.assert_array_equal(shared[0], port[0])
    mets = np.log10(_grid(jst).metallicities).astype(np.float32)
    pz = {"log10_metallicity": rng.uniform(-3.5, -1.5, 16).astype(np.float32),
          "log10_sigma": rng.uniform(0.05, 0.6, 16).astype(np.float32)}
    zp = tsfh.zdist_weights("normal", {k: torch.as_tensor(v) for k, v in
                                       pz.items()}, torch.as_tensor(mets))
    zr = jax.vmap(lambda d: jsfh.zdist_weights("normal", d, mets))(
        {k: jnp.asarray(v) for k, v in pz.items()})
    assert np.abs(zp.numpy() - np.asarray(zr)).max() <= 2e-6
    for bad in (lambda: tsfh.sfh_weights("nope", p, None),
                lambda: tsfh.zdist_weights("nope", pz, None)):
        with pytest.raises(ValueError, match="unknown"):
            bad()


@functools.lru_cache(maxsize=None)
def _pair(family, zdist):
    names = ("log10_mass", "redshift") + FAMILIES.get(family, ((),))[0] + (
        "log10_metallicity", "tau_v")
    if zdist == "normal":
        names += ("log10_sigma",)
    fixed = ({"fractions": [0.1, 0.3, 0.2, 0.25, 0.15], "min_age": 3e6}
             if family == "dense_basis" else {})
    out = []
    for pkg in (jst, tt):
        filt = pkg.FilterSet([pkg.tophat_filter(c, ct, w) for c, ct, w in
                              zip(_CODES, _CENTERS, _WIDTHS)])
        kw = dict(device="cpu") if pkg is tt else {}
        out.append(pkg.BatchSEDSimulator(
            _grid(pkg), filt, names, sfh=family, zdist=zdist,
            fixed_params=fixed, photometry_backend="xla", **kw))
    out[1].load_state(_jax_state(out[0]))
    return out


@pytest.mark.parametrize("family,zdist", [
    ("delayed_tau", "normal"), ("gaussian_burst", "delta"),
    ("double_power_law", "delta"), ("dense_basis", "normal")])
def test_simulator_end_to_end(family, zdist):
    """The simulator with a family against the JAX one (the weights of
    every family are held above; the closed-form test below runs each
    family through the simulator)."""
    jsim, tsim = _pair(family, zdist)
    rng = np.random.default_rng(7)
    n = 48
    cols = [rng.uniform(8, 11, n), rng.uniform(0.05, 8, n)]
    if family in FAMILIES:
        cols += [v for k, v in _params(family, n, seed=7).items()
                 if k != "max_age"]
    cols += [rng.uniform(-3.5, -2, n), rng.uniform(0, 2, n)]
    if zdist == "normal":
        cols += [rng.uniform(0.05, 0.5, n)]
    theta = np.column_stack(cols).astype(np.float32)
    port = tsim.photometry(theta).numpy()
    ref = np.asarray(jsim.photometry(jnp.asarray(theta)))
    assert np.isfinite(port).all() and (port >= 0).all()
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert (np.abs(port - ref) / scale).max() < 1e-4


# every family's weights carry unit mass into the photometry: on a grid
# whose every cell holds the same flat L_ν, a band flux is the closed form
# M·L0·(1+z)/(4π d_L²) whatever the history (tests/test_analytic_physics.py,
# its bound rtol 2e-3: float32 quadrature distances and pipeline)
_FAMILY_THETA = {
    "constant": (("min_age",), (3e7,)),
    "lognormal": (("peak_age", "tau"), (2e8, 0.3)),
    "delayed_tau": (("tau",), (5e8,)),
    "exponential": (("tau",), (1e9,)),
    "rising_exponential": (("tau",), (7e8,)),
    "gaussian_burst": (("burst_age", "sigma"), (1e8, 2e7)),
    "double_power_law": (("peak_age", "alpha", "beta"), (8e8, 3.0, 2.0)),
    "dense_basis": ((), ()),
}


@pytest.mark.parametrize("family,zdist", [
    (family, ("delta", "normal")[i % 2])
    for i, family in enumerate(sorted(_FAMILY_THETA))])
def test_closed_form_flux_scale_every_family(family, zdist):
    from test_analytic_physics import BANDS, NJY_CGS, lum_dist_cm

    lam = np.geomspace(300.0, 1.0e7, 4096)
    l0 = 1.0e20
    grid = tt.SPSGrid(name="analytic", log10_ages=np.array([7.0, 9.5]),
                      metallicities=np.array([1e-3, 1e-2]), lam=lam,
                      spectra={"incident": np.full((2, 2, 4096), l0,
                                                   np.float32)})
    names, values = _FAMILY_THETA[family]
    filters = tt.FilterSet([tt.tophat_filter(*band) for band in BANDS])
    sim = tt.BatchSEDSimulator(
        grid, filters, ("log10_mass", "redshift") + names
        + ("log10_metallicity", "tau_v"), sfh=family, zdist=zdist,
        fixed_params=({"fractions": [0.5, 0.3, 0.2]}
                      if family == "dense_basis" else {}),
        emission=tt.EmissionConfig(igm="none"), photometry_backend="xla",
        device="cpu")
    for z in (0.5, 3.0):
        theta = np.array([[9.0, z, *values, -2.5, 0.0]], np.float32)
        flux = sim.photometry(theta).numpy()[0]
        expect = (1.0e9 * l0 * (1.0 + z) / (4.0 * np.pi * lum_dist_cm(z) ** 2)
                  / NJY_CGS)
        np.testing.assert_allclose(flux, expect, rtol=2e-3)


def test_port_matches_float64_oracle():
    """`tests/test_grid_parity.py`'s float64 numpy oracle of θ → photometry
    (lognormal, delta Z, Calzetti, Inoue14, quadrature cosmology) against
    the port's exact route, at that test's bound: median < 0.5 %, max < 2 %
    (the JAX package measures median 0.12 %, max 0.83 %, BASELINE.md)."""
    from test_grid_parity import Float64Oracle

    jgrid = jst.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=4096, seed=0)
    bands = (("F115W", 11500.0, 2600.0), ("F200W", 20000.0, 4600.0),
             ("F356W", 35600.0, 7800.0), ("F444W", 44400.0, 10200.0))
    oracle = Float64Oracle(jgrid, jst.FilterSet(
        [jst.tophat_filter(*b) for b in bands]))
    sim = tt.BatchSEDSimulator(
        tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=4096, seed=0),
        tt.FilterSet([tt.tophat_filter(*b) for b in bands]),
        ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
         "tau_v"), emission=tt.EmissionConfig(igm="inoue14"),
        photometry_backend="xla", device="cpu")
    rng = np.random.default_rng(0)
    n = 24
    theta = np.stack([
        rng.uniform(8, 11, n), rng.uniform(0.1, 7, n),
        rng.uniform(5e7, 8e8, n), rng.uniform(0.3, 0.9, n),
        rng.uniform(-3.5, -1.6, n), rng.uniform(0, 1.5, n)],
        axis=1).astype(np.float32)
    got = sim.photometry(theta).numpy().astype(np.float64)
    want = np.stack([oracle.photometry_one(t) for t in theta])
    mask = want > want.max() * 1e-6
    rel = np.abs(got[mask] - want[mask]) / want[mask]
    assert np.median(rel) < 0.005 and rel.max() < 0.02
