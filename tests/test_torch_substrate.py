"""Port parity, substrate modules: units, cosmology, filters, instruments,
grids, dust, IGM and SFH weights of `synference_tpu_torch` against the JAX
package on the same numpy inputs.

Tolerance: float32 rtol 1e-5 unless stated. Host-numpy code that the port
copies (filter tables, instrument curves, synthetic grids, HDF5 layout) must
agree exactly. Where a comparison is loosened, the reason is at the test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu import grids as jgrids
from synference_tpu import instruments as jinst
from synference_tpu import units as ju
from synference_tpu_torch import units as tu

RTOL = 1e-5


def _close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

_FLUX = np.random.default_rng(0).lognormal(2.0, 2.0, 257).astype(np.float32)
_ERR = (0.1 * _FLUX + 1.0).astype(np.float32)


@pytest.mark.parametrize("name", [
    "njy_to_ab", "ab_to_njy", "njy_to_jy", "jy_to_njy", "f_jy_to_asinh",
    "asinh_to_f_jy"])
def test_units_one_arg(name):
    x = _FLUX if name != "ab_to_njy" else (20.0 + _FLUX % 10).astype(np.float32)
    if name == "f_jy_to_asinh":
        x = x * 1e-9
    if name == "asinh_to_f_jy":
        x = (24.0 + _FLUX % 8).astype(np.float32)
    _close(getattr(tu, name)(torch.as_tensor(x)), getattr(ju, name)(x))


@pytest.mark.parametrize("unit", ["AB", "asinh", "log10_nJy", "Jy"])
def test_convert_flux_and_err(unit):
    fb = np.linspace(3.0, 9.0, _FLUX.size).astype(np.float32)
    _close(tu.convert_flux(torch.as_tensor(_FLUX), "nJy", unit,
                           f_b_njy=torch.as_tensor(fb)),
           ju.convert_flux(_FLUX, "nJy", unit, f_b_njy=fb))
    _close(tu.convert_flux_err(torch.as_tensor(_FLUX), torch.as_tensor(_ERR),
                               "nJy", unit, f_b_njy=torch.as_tensor(fb)),
           ju.convert_flux_err(_FLUX, _ERR, "nJy", unit, f_b_njy=fb))


def test_depth_sigma():
    for depth in (25.0, 28.3, 29.5, 31.0):
        _close(float(tu.ab_depth_to_sigma_njy(depth)),
               float(ju.ab_depth_to_sigma_njy(depth)), rtol=1e-6)


# ---------------------------------------------------------------------------
# cosmology
# ---------------------------------------------------------------------------

_Z = np.concatenate([[0.0, 1e-4, 1e-3], np.geomspace(0.01, 25.0, 200)]
                    ).astype(np.float32)


@pytest.mark.parametrize("fn", ["age_yr", "luminosity_distance_cm",
                                "comoving_distance_mpc"])
def test_cosmology(fn):
    port = getattr(tt.PLANCK18, fn)(torch.as_tensor(_Z))
    ref = getattr(jst.PLANCK18, fn)(jnp.asarray(_Z))
    _close(port, ref, atol=1e-30)


# ---------------------------------------------------------------------------
# filters, instruments
# ---------------------------------------------------------------------------

_NIRCAM = ["JWST/NIRCam.F090W", "JWST/NIRCam.F115W", "JWST/NIRCam.F150W",
           "JWST/NIRCam.F200W", "JWST/NIRCam.F277W", "JWST/NIRCam.F356W",
           "JWST/NIRCam.F444W"]


def test_instrument_curves_identical():
    port = tt.load_instrument_filters(_NIRCAM)
    ref = jinst.load_instrument_filters(_NIRCAM)
    assert port.codes == ref.codes
    for a, b in zip(port.filters, ref.filters):
        np.testing.assert_array_equal(a.lam, b.lam)
        np.testing.assert_array_equal(a.transmission, b.transmission)


@pytest.mark.parametrize("z_max", [6.0, 25.0])
def test_shifted_table_identical(z_max):
    lam = np.geomspace(300.0, 1e7, 1024)
    port = tt.load_instrument_filters(_NIRCAM).shifted_table(lam, z_max)
    ref = jinst.load_instrument_filters(_NIRCAM).shifted_table(
        lam, z_max)
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1:] == ref[1:]


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------


def _assert_grid_equal(a, b):
    np.testing.assert_array_equal(a.log10_ages, b.log10_ages)
    np.testing.assert_array_equal(a.metallicities, b.metallicities)
    np.testing.assert_array_equal(a.lam, b.lam)
    assert sorted(a.spectra) == sorted(b.spectra)
    for t in a.spectra:
        np.testing.assert_array_equal(a.spectra[t], b.spectra[t])
    assert list(a.extra_axes) == list(b.extra_axes)
    assert a.cells_per_age == b.cells_per_age


def test_synthetic_grids_identical():
    kw = dict(n_ages=8, n_mets=3, n_wav=300)
    _assert_grid_equal(tt.make_synthetic_grid(**kw),
                       jst.make_synthetic_grid(**kw))
    port = tt.make_synthetic_multiaxis_grid(n_u=3, lam_min=150.0, **kw)
    ref = jgrids.make_synthetic_multiaxis_grid(n_u=3, lam_min=150.0, **kw)
    _assert_grid_equal(port, ref)
    _assert_grid_equal(port.fix_axes({"ionisation_parameter": -2.0}),
                       ref.fix_axes({"ionisation_parameter": -2.0}))
    assert port.is_log_uniform and ref.is_log_uniform


def test_grid_resample_and_device_table():
    g = tt.make_synthetic_grid(n_ages=6, n_mets=3, n_wav=200)
    g.lam = g.lam * (1.0 + 1e-3 * np.sin(np.arange(g.n_wav)))  # not log-uniform
    r = jst.make_synthetic_grid(n_ages=6, n_mets=3, n_wav=200)
    r.lam = g.lam.copy()
    assert not g.is_log_uniform and not r.is_log_uniform
    _assert_grid_equal(g.resampled_loglam(), r.resampled_loglam())
    tab = g.spectra_device("total", device="cpu")
    assert tab.dtype == torch.float32 and tab.shape == (18, 200)
    np.testing.assert_array_equal(tab.numpy(),
                                  np.asarray(r.spectra_device("total")))


def test_grid_hdf5_round_trip_both_ways(tmp_path):
    port = tt.make_synthetic_multiaxis_grid(n_u=3, n_ages=6, n_mets=3, n_wav=128)
    ref = jgrids.make_synthetic_multiaxis_grid(n_u=3, n_ages=6, n_mets=3,
                                                  n_wav=128)
    port.to_hdf5(str(tmp_path / "port.h5"))
    ref.to_hdf5(str(tmp_path / "ref.h5"))
    fixed = {"ionisation_parameter": -2.0}
    _assert_grid_equal(
        tt.SPSGrid.from_hdf5(str(tmp_path / "ref.h5"), fixed_axes=fixed),
        jst.SPSGrid.from_hdf5(str(tmp_path / "port.h5"), fixed_axes=fixed))


# ---------------------------------------------------------------------------
# dust, IGM
# ---------------------------------------------------------------------------

_LAM = np.geomspace(150.0, 1e7, 2000).astype(np.float32)


@pytest.mark.parametrize("law,params", [
    ("calzetti2000", {}), ("calzetti2000", {"bump": 1.5, "delta": -0.3}),
    ("power_law", {"slope": -0.7}), ("smc", {})])
def test_attenuation_curve(law, params):
    from synference_tpu import dust as jd
    from synference_tpu_torch import dust as td

    _close(td.attenuation_curve(law, torch.as_tensor(_LAM), params),
           jd.attenuation_curve(law, jnp.asarray(_LAM), params), atol=1e-7)


@pytest.mark.parametrize("model", ["inoue14", "madau95"])
@pytest.mark.parametrize("z", [0.5, 1.5, 3.0, 4.9, 7.0, 12.0])
def test_igm_transmission(model, z):
    """T = exp(−τ): τ is a sum of float32 power laws, so T's relative error
    grows like τ·ulp; an absolute 1e-6 covers the deep troughs."""
    from synference_tpu import igm as ji
    from synference_tpu_torch import igm as ti

    lam_obs = _LAM * np.float32(1.0 + z)
    _close(ti.igm_transmission(torch.as_tensor(lam_obs), z, model),
           ji.igm_transmission(jnp.asarray(lam_obs), jnp.float32(z), model),
           atol=1e-6)


def test_igm_table_rows_batched():
    """The port evaluates many redshifts in one broadcast call; each row must
    match the JAX package's scalar-z evaluation."""
    from synference_tpu import igm as ji
    from synference_tpu_torch import igm as ti

    zs = np.array([0.3, 2.5, 5.5], np.float32)
    lam = torch.as_tensor(_LAM)
    port = ti.igm_transmission(lam[None, :] * (1.0 + torch.as_tensor(zs)[:, None]),
                               torch.as_tensor(zs)[:, None])
    for i, z in enumerate(zs):
        _close(port[i], ji.igm_transmission(jnp.asarray(_LAM) * (1.0 + z),
                                            jnp.float32(z)), atol=1e-6)


# ---------------------------------------------------------------------------
# SFH / metallicity weights
# ---------------------------------------------------------------------------


def test_sfh_and_zdist_weights():
    import jax

    from synference_tpu import sfh as js
    from synference_tpu_torch import sfh as ts

    grid = tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=64)
    rng = np.random.default_rng(3)
    n = 256
    p = {
        "max_age": rng.uniform(1e8, 1.3e10, n),
        "peak_age": rng.uniform(1e7, 2e9, n),
        "tau": rng.uniform(0.05, 1.5, n),
        "log10_metallicity": rng.uniform(-4.5, -1.0, n),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    samp_t = ts.make_age_sampling(grid.age_bin_edges_yr, "cpu")
    samp_j = js.make_age_sampling(grid.age_bin_edges_yr)
    port = ts.sfh_weights("lognormal", {k: torch.as_tensor(v) for k, v in
                                        p.items()}, samp_t)
    ref = jax.vmap(lambda d: js.sfh_weights("lognormal", d, samp_j))(
        {k: jnp.asarray(v) for k, v in p.items()})
    # bin masses are differences of Φ at neighbouring edges, so float32
    # rounding of Φ (~1 near the top edges) cancels into absolute errors up
    # to ~2e-5 of the row sum in BOTH packages (measured against the float64
    # oracle below); hold each to the oracle at 3e-5 and to each other at
    # twice that
    from scipy.special import ndtr

    e = samp_t.edges.double().numpy()
    p64 = {k: v.astype(np.float64) for k, v in p.items()}
    tau = np.maximum(p64["tau"], 1e-3)[:, None]
    mu = np.log(np.maximum(p64["max_age"] - p64["peak_age"], 1e4))[:, None] + tau**2
    x = np.clip(p64["max_age"][:, None] - e[None, :], 0.0, None)
    m = ndtr((np.log(np.maximum(x, 1.0)) - mu) / tau)
    oracle = np.maximum(m[:, :-1] - m[:, 1:], 0.0)
    oracle /= oracle.sum(axis=1, keepdims=True)
    _close(port, oracle, rtol=0.0, atol=3e-5)
    _close(ref, oracle, rtol=0.0, atol=3e-5)
    _close(port, ref, rtol=0.0, atol=6e-5)
    np.testing.assert_allclose(port.sum(1).numpy(), 1.0, rtol=1e-5)
    mets = np.log10(grid.metallicities).astype(np.float32)
    zp = ts.zdist_weights("delta", {k: torch.as_tensor(v) for k, v in
                                    p.items()}, torch.as_tensor(mets))
    zr = jax.vmap(lambda d: js.zdist_weights("delta", d, mets))(
        {k: jnp.asarray(v) for k, v in p.items()})
    _close(zp, zr, atol=1e-6)
    # the other families are ported too (tests/test_torch_sfh_families.py
    # holds each to the JAX package); delayed-τ on the same draws, with τ in
    # years
    pd = dict(p, tau=(p["tau"] * 1e9).astype(np.float32))
    dt = ts.sfh_weights("delayed_tau", {k: torch.as_tensor(v) for k, v in
                                        pd.items()}, samp_t)
    dr = jax.vmap(lambda d: js.sfh_weights("delayed_tau", d, samp_j))(
        {k: jnp.asarray(v) for k, v in pd.items()})
    _close(dt, dr, atol=5e-6)
    with pytest.raises(ValueError, match="unknown SFH family"):
        ts.sfh_weights("nope", {}, samp_t)
