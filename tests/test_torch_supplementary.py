"""Port parity, `supplementary.py`: the 22 quantities of `SUPP_FUNCTIONS`
against the JAX package's.

On one shared context of arrays (a 2048-column rest grid from 300 Å to
2·10⁴ Å, so that every window holds columns, and seeded luminosities, SFH
masses and SFZH weights): each function to 1e-5 relative, magnitudes and
colours to 1e-4 mag. Two groups are held otherwise, each for a stated
reason:
- `beta_uv` and the line quantities (`ew_*`, `balmer_decrement`) subtract
  nearly equal sums; the port accumulates them in float64, the JAX package in
  float32, which loses ~1e-3 of β and ~1e-4 of an EW. They are held to the
  JAX formula evaluated in float64 by numpy at 1e-5, and to the JAX package
  within its float32 error (β 1e-2 relative; EWs and the decrement 1e-3 of
  the column's largest value).
- `n_ion` (~1e53 photons/s) overflows float32 in both packages: both give
  inf, and `xi_ion` with it. The test holds the two to the same values.

End to end, from each package's own `simulate(θ, want_spectra=True)` on the
test grid (256 rows): the lognormal SFH's bin masses are CDF differences, so
one float32 ulp moves a small (young) bin by up to ~1e-3 relative between
the packages (ROADMAP queue 3), and the UV of an old population and the
recent SFR come from such bins. Measured: m_uv median 5.3e-5, p95 1.1e-3,
max 3.4e-3 mag; sfr_10 and burstiness median 9.8e-6, p95 5.0e-4, max
1.6e-3 relative; the SFH- and cell-weighted ages median ≤ 1.8e-6, p95
≤ 1.9e-5; beta_uv median 2.2e-4, p95 1.1e-3 (with the float32 cancellation
above); ew_oiii p99 2.7e-3 relative. The test holds medians to 1e-4
relative (1e-4 mag), 95th percentiles to 2e-3 relative (5e-3 mag), beta_uv
to 1e-2 and ew_oiii to 1e-2 of its column's largest value. The test grid
has no column within 30 Å of Hα or Hβ, so both packages give 0 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu import supplementary as jsupp
from synference_tpu.units import C_AA_S
from synference_tpu_torch import supplementary as tsupp

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
PRIOR = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 4.0),
         "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
         "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
MAGS = ("m_uv", "app_m_uv", "u_minus_v", "v_minus_j")
CANCEL = ("beta_uv", "balmer_decrement", "ew_halpha", "ew_hbeta", "ew_oiii")
OVERFLOW = ("n_ion", "xi_ion")
B, L, A, Z = 64, 2048, 12, 4


@pytest.fixture(scope="module")
def shared():
    """One context of arrays both packages read."""
    rng = np.random.default_rng(0)
    lam = np.geomspace(300.0, 2.0e4, L)
    ages = np.logspace(6.0, 10.0, A)
    edges = np.concatenate([[0.0], np.sqrt(ages[:-1] * ages[1:]), [1.4e10]])
    slope = rng.uniform(-2.5, 0.5, (B, 1))
    lines = sum(amp * rng.uniform(0.5, 1.5, (B, 1)) * np.exp(
        -0.5 * ((lam - lam0) / 15.0) ** 2)
        for lam0, amp in ((6563.0, 0.9), (4861.0, 0.4), (5007.0, 0.6)))
    lnu = (1e28 * (lam / 1500.0) ** slope * (1.0 + lines)
           * rng.uniform(0.5, 2.0, (B, 1)))
    sfh = rng.uniform(0.0, 1.0, (B, A)) ** 3 * 1e9
    arrays = {
        "lam": lam, "dlam": np.gradient(lam), "lnu": lnu,
        "lnu_intrinsic": lnu * 1.3, "sfh_mass": sfh,
        "sfzh": (sfh[:, :, None] * rng.dirichlet(np.ones(Z), (B, A))
                 ).reshape(B, -1),
        "ages_yr": ages, "age_bin_edges": edges,
        "bol_lum_flat": rng.uniform(0.1, 10.0, A * Z),
        "cum_lum": np.cumsum(rng.uniform(0.0, 1.0, (A * Z, L)), axis=1),
        "z": rng.uniform(0.1, 4.0, B),
        "distance_modulus": rng.uniform(35.0, 48.0, B),
    }
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    jctx = {k: jnp.asarray(v) for k, v in arrays.items()}
    jctx["cells_per_age"] = Z
    tctx = {k: torch.as_tensor(v) for k, v in arrays.items()}
    tctx.update(cells_per_age=Z, lam_host=arrays["lam"])
    return arrays, jctx, tctx


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def _line_flux64(arrays, lam0, width=30.0, cont_off=80.0, cont_w=50.0):
    """The JAX package's line flux, float32 windows, float64 arithmetic."""
    lam = arrays["lam"]
    llam = arrays["lnu"].astype(np.float64) * (
        C_AA_S * 1.0e-10 / lam.astype(np.float64) ** 2)
    line_m = np.abs(lam - np.float32(lam0)) < width
    cont_m = ((np.abs(lam - np.float32(lam0 - cont_off)) < cont_w)
              | (np.abs(lam - np.float32(lam0 + cont_off)) < cont_w))
    cont = (llam * cont_m).sum(-1) / max(cont_m.sum(), 1)
    excess = ((llam - cont[:, None]) * line_m
              * arrays["dlam"].astype(np.float64)).sum(-1)
    return excess, cont


def _oracle64(name, arrays):
    """Float64 evaluation of the JAX formulas of the cancelling quantities."""
    if name == "beta_uv":
        lam = arrays["lam"]
        m = (lam >= 1250.0) & (lam <= 3000.0)
        x = np.log(lam[m]).astype(np.float64)
        y = np.log(np.maximum(arrays["lnu"][:, m], 1e-30)).astype(np.float64)
        n = m.sum()
        slope = ((n * (x * y).sum(-1) - x.sum() * y.sum(-1))
                 / (n * (x * x).sum() - x.sum() ** 2))
        return slope - 2.0
    if name == "balmer_decrement":
        return (_line_flux64(arrays, 6563.0)[0]
                / np.maximum(_line_flux64(arrays, 4861.0)[0], 1e-30))
    lam0 = {"ew_halpha": 6563.0, "ew_hbeta": 4861.0, "ew_oiii": 5007.0}[name]
    fl, cont = _line_flux64(arrays, lam0)
    return fl / np.maximum(cont, 1e-30)


@pytest.mark.parametrize("name", sorted(jsupp.SUPP_FUNCTIONS))
def test_function_matches_jax_on_shared_context(shared, name):
    arrays, jctx, tctx = shared
    assert set(tsupp.SUPP_FUNCTIONS) == set(jsupp.SUPP_FUNCTIONS)
    got = tsupp.SUPP_FUNCTIONS[name](tctx).numpy()
    ref = np.asarray(jsupp.SUPP_FUNCTIONS[name](jctx))
    assert got.shape == (B,) and got.dtype == np.float32
    if name in OVERFLOW:
        assert np.isinf(ref).all()
        np.testing.assert_array_equal(got, ref)
    elif name in CANCEL:
        assert np.abs(ref).max() > 0  # the windows hold columns
        np.testing.assert_allclose(got, _oracle64(name, arrays), rtol=1e-5)
        if name == "beta_uv":
            assert _rel(got, ref).max() < 1e-2
        else:
            assert np.abs(got - ref).max() < 1e-3 * np.abs(ref).max()
    elif name in MAGS:
        assert np.abs(got - ref).max() < 1e-4
    else:
        assert _rel(got, ref).max() < 1e-5, _rel(got, ref).max()


@pytest.fixture(scope="module")
def simulated(test_grid):
    """Each package's own simulate(θ, want_spectra=True) on the same θ."""
    theta = np.stack([tt.draw_from_hypercube(
        PRIOR, 256, rng=1, unlog_keys=["log10_peak_age"])[p] for p in PNAMES],
        axis=1)
    filt = [("F200W", 20000.0, 4600.0), ("F444W", 44400.0, 10200.0)]
    jsim = jst.BatchSEDSimulator(
        test_grid, jst.FilterSet([jst.tophat_filter(*f) for f in filt]),
        PNAMES, photometry_backend="xla")
    grid = tt.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0)
    sim = tt.BatchSEDSimulator(
        grid, tt.FilterSet([tt.tophat_filter(*f) for f in filt]), PNAMES,
        device="cpu")
    names = sorted(jsupp.SUPP_FUNCTIONS)
    ref = np.asarray(jax.jit(lambda t: jsupp.compute_supplementary(
        names, jsim, t, jsim.simulate(t, want_spectra=True)))(
            jnp.asarray(theta)))
    got = tt.compute_supplementary(names, sim, theta,
                                   sim.simulate(theta, want_spectra=True))
    return names, got.numpy(), ref


def test_end_to_end_matches_jax(simulated):
    names, got, ref = simulated
    assert got.shape == ref.shape == (256, len(names))
    for j, name in enumerate(names):
        if name in OVERFLOW:
            np.testing.assert_array_equal(np.isinf(got[:, j]),
                                          np.isinf(ref[:, j]))
            continue
        if not np.abs(ref[:, j]).max() > 0:  # no column in the window
            np.testing.assert_array_equal(got[:, j], ref[:, j])
            continue
        assert np.isfinite(got[:, j]).all(), name
        if name in MAGS:
            d = np.abs(got[:, j] - ref[:, j])
            assert np.median(d) < 1e-4 and np.quantile(d, 0.95) < 5e-3, (
                name, np.median(d), np.quantile(d, 0.95))
        elif name == "beta_uv":
            assert _rel(got[:, j], ref[:, j]).max() < 1e-2
        elif name in CANCEL:
            d = np.abs(got[:, j] - ref[:, j])
            assert d.max() < 1e-2 * np.abs(ref[:, j]).max(), name
        else:
            r = _rel(got[:, j], ref[:, j])
            assert np.median(r) < 1e-4 and np.quantile(r, 0.95) < 2e-3, (
                name, np.median(r), np.quantile(r, 0.95))


def test_grid_tables_computed_once(test_grid):
    """The float64 per-cell tables are made once per simulator."""
    sim = tt.BatchSEDSimulator(
        tt.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0),
        tt.FilterSet([tt.tophat_filter("F200W", 20000.0, 4600.0)]), PNAMES,
        device="cpu")
    theta = torch.tensor([[9.0, 1.0, 3e8, 0.5, -2.5, 0.3]])
    out = sim.simulate(theta, want_spectra=True)
    first = tsupp.supplementary_context(sim, theta, out)
    again = tsupp.supplementary_context(sim, theta, out)
    assert first["cum_lum"] is again["cum_lum"]
    lam = np.asarray(test_grid.lam)
    inc = test_grid.spectra["incident"].reshape(-1, lam.size)
    bol = (inc.astype(np.float64) * (C_AA_S / lam**2) * np.gradient(lam)
           ).sum(-1) / 1e40
    np.testing.assert_array_equal(first["bol_lum_flat"].numpy(),
                                  bol.astype(np.float32))
