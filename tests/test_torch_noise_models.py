"""Port parity, the noise-model zoo: the port's models against the JAX
package's on the same catalogue, the same fluxes and the same random
numbers (the JAX package's key splits reproduced and the draws passed to the
port as `draws=`), plus distribution checks of the port's own generator
draws, HDF5 files across the packages and the feature pipeline with
empirical models.

Tolerances:
- binned fits (host numpy in both): exact; σ tables from a catalogue
  (float32 unit conversions before the fit): relative 1e-6;
- `apply` with shared draws: relative 1e-4 on every flux and σ (float32
  interpolation, ndtri and unit conversions; measured ≤ 4.7e-6 in nJy and
  asinh space, ≤ 4.8e-5 through AB magnitudes), the truncated normal alone
  2e-5;
- truncated-normal σ from the port's generator: a KS test against scipy's
  truncnorm at the same (μ, σ), p > 1e-3.
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from synference_tpu import noise_models as jnm
from synference_tpu_torch import noise_models as tnm
import synference_tpu_torch as tt


def _catalogue(n=20000, seed=0):
    """A seeded synthetic catalogue: log-uniform fluxes, errors of a 29-mag
    floor plus 5 per cent with scatter, some negative low-SNR fluxes."""
    rng = np.random.default_rng(seed)
    flux = 10 ** rng.uniform(0, 4, n)
    err = (6.0 + 0.05 * flux) * rng.lognormal(0, 0.2, n)
    flux = flux + err * rng.normal(size=n)
    return flux, err


def _keys(n, seed=1):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _jax_draws(key, shape, names):
    """The draws the JAX model makes from `key`, named as the port's."""
    ks = jax.random.split(key, len(names)) if len(names) > 1 else [key]
    out = {}
    for k, name in zip(ks, names):
        fn = jax.random.uniform if name.startswith("u") else jax.random.normal
        out[name] = np.asarray(fn(k, shape))
    return out


def _close(port, ref, rtol=1e-5):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=1e-6 * np.abs(
        ref).max())


def test_truncnorm_matches_jax_and_scipy():
    rng = np.random.default_rng(2)
    # μ > 0, as a median error is: deep truncation (Φ(−μ/σ) → 1) is
    # ill-conditioned in float32 in both packages
    mu = rng.uniform(0.02, 3, 4096).astype(np.float32)
    sd = rng.uniform(0.05, 2, 4096).astype(np.float32)
    sd[:8] = 0.0  # zero width returns mu
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jnm._truncnorm_nonneg(key, jnp.asarray(mu),
                                           jnp.asarray(sd)))
    u01 = np.asarray(jax.random.uniform(key, mu.shape))
    port = tnm._truncnorm_nonneg(torch.as_tensor(u01), torch.as_tensor(mu),
                                 torch.as_tensor(sd)).numpy()
    _close(port, ref, rtol=2e-5)
    np.testing.assert_array_equal(port[:8], mu[:8])
    # the port's own draws at one (μ, σ) against scipy's truncated normal
    gen = torch.Generator().manual_seed(0)
    m, s = 0.5, 1.2
    draws = tnm._truncnorm_nonneg(torch.rand(20000, generator=gen),
                                  torch.full((20000,), m),
                                  torch.full((20000,), s)).numpy()
    assert (draws >= 0).all()
    ks = stats.kstest(draws, stats.truncnorm(-m / s, np.inf, loc=m,
                                             scale=s).cdf)
    assert ks.pvalue > 1e-3


def test_binned_fit_is_the_jax_fit():
    flux, err = _catalogue()
    for kw in (dict(), dict(log_bins=False, num_bins=12),
               dict(precomputed_bins=np.linspace(-10, 1e4, 9))):
        ref = jnm.fit_binned_error_model(flux, err, **kw)
        port = tnm.fit_binned_error_model(flux, err, **kw)
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="enough valid bins"):
        tnm.fit_binned_error_model(flux[:5], err[:5])


def _pairs(flux, err):
    """(port model, JAX model) of every empirical kind on one catalogue."""
    ul = dict(upper_limits=True, treat_as_upper_limits_below=2.0)
    out = [
        (tnm.EmpiricalNoiseModel.from_catalogue(flux[flux > 0],
                                                err[flux > 0]),
         jnm.EmpiricalNoiseModel.from_catalogue(flux[flux > 0],
                                                err[flux > 0])),
        (tnm.AsinhEmpiricalNoiseModel.from_catalogue(flux, err),
         jnm.AsinhEmpiricalNoiseModel.from_catalogue(flux, err)),
        (tnm.AsinhEmpiricalNoiseModel.from_catalogue(
            flux, err, error_type="observed"),
         jnm.AsinhEmpiricalNoiseModel.from_catalogue(
             flux, err, error_type="observed")),
    ]
    for fb, eb, unit in (("scatter_limit", "flux", "nJy"),
                         ("upper_limit", "upper_limit", "nJy"),
                         (25.0, "sig_3", "AB"), ("scatter_limit", "sig_1",
                                                 "nJy")):
        kw = dict(flux_unit="nJy", interpolation_unit=unit,
                  upper_limit_flux_behaviour=fb,
                  upper_limit_flux_err_behaviour=eb, **ul)
        if unit == "AB":
            keep = flux > 0
            args = (flux[keep], err[keep])
        else:
            args = (flux, err)
        out.append((tnm.GeneralEmpiricalNoiseModel.from_catalogue(*args, **kw),
                    jnm.GeneralEmpiricalNoiseModel.from_catalogue(*args,
                                                                  **kw)))
    out.append((tnm.GeneralEmpiricalNoiseModel.from_catalogue(
        flux[flux > 0], err[flux > 0], flux_unit="nJy",
        interpolation_unit="AB", sigma_clip=2.0),
        jnm.GeneralEmpiricalNoiseModel.from_catalogue(
            flux[flux > 0], err[flux > 0], flux_unit="nJy",
            interpolation_unit="AB", sigma_clip=2.0)))
    return out


def test_tables_and_apply_match_jax_on_shared_draws():
    flux, err = _catalogue()
    obs = np.concatenate([np.geomspace(0.5, 3e4, 250),
                          np.linspace(-5, 5, 6)]).astype(np.float32)
    for (port, ref), key in zip(_pairs(flux, err), _keys(9)):
        for name in ("bin_centers", "median_error_in_bin",
                     "std_error_in_bin"):
            np.testing.assert_allclose(getattr(port, name),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-6, err_msg=name)
        if getattr(ref, "upper_limit_value", None) is not None:
            assert port.upper_limit_value == pytest.approx(
                ref.upper_limit_value, rel=1e-5)
        x = obs[obs > 0] if getattr(port, "interpolation_unit", None) == \
            tnm.U.FluxUnit.AB else obs
        draws = _jax_draws(key, x.shape, type(port).DRAWS)
        pn, ps = port.apply(None, torch.as_tensor(x), draws=draws)
        rn, rs = ref.apply(key, jnp.asarray(x))
        rn, rs = np.asarray(rn), np.asarray(rs)
        _close(pn, rn, rtol=1e-4)
        _close(ps, rs, rtol=1e-4)


def test_depth_and_spectral_models_on_shared_draws():
    key = jax.random.PRNGKey(5)
    x = np.geomspace(1, 1e4, 64).astype(np.float32)
    for port, ref in (
            (tnm.DepthNoiseModel(28.5, 5.0, 1.0, 30.0),
             jnm.DepthNoiseModel(28.5, 5.0, 1.0, 30.0)),
            (tnm.SpectralNoiseModel(np.linspace(1, 3, 64)),
             jnm.SpectralNoiseModel(np.linspace(1, 3, 64)))):
        draws = {"g": np.asarray(jax.random.normal(key, x.shape))}
        pn, ps = port.apply(None, torch.as_tensor(x), draws=draws)
        rn, rs = ref.apply(key, jnp.asarray(x))
        _close(pn, rn)
        _close(ps, rs)
    # generator draws: the depth model's σ·N(0,1) scatter
    gen = torch.Generator().manual_seed(1)
    noisy, sig = tnm.DepthNoiseModel(28.0).apply(gen, torch.zeros(50000))
    assert abs(float(noisy.std() / sig[0]) - 1.0) < 0.02


def test_create_from_catalogue_every_type():
    flux, err = _catalogue(5000, seed=3)
    f = {"A": flux, "B": flux * 2}
    e = {"A": err, "B": err * 2}
    for kind, cls in (("general", "GeneralEmpiricalNoiseModel"),
                      ("asinh", "AsinhEmpiricalNoiseModel"),
                      ("depth", "DepthNoiseModel")):
        port = tnm.create_noise_models_from_catalogue(f, e, kind)
        ref = jnm.create_noise_models_from_catalogue(f, e, kind)
        assert sorted(port) == ["A", "B"]
        assert type(port["A"]).__name__ == cls
        if kind == "depth":
            assert port["B"].depth_ab == pytest.approx(ref["B"].depth_ab)
        else:
            np.testing.assert_allclose(port["B"].median_error_in_bin,
                                       np.asarray(ref["B"].median_error_in_bin),
                                       rtol=1e-6)
    pos = {"A": np.abs(flux) + 1}
    emp = tnm.create_noise_models_from_catalogue(pos, {"A": err}, "empirical")
    assert type(emp["A"]) is tnm.EmpiricalNoiseModel
    with pytest.raises(ValueError, match="unknown model_type"):
        tnm.create_noise_models_from_catalogue(f, e, "nope")


@pytest.mark.skipif(importlib.util.find_spec("h5py") is None,
                    reason="needs h5py")
def test_hdf5_both_ways(tmp_path):
    import h5py

    flux, err = _catalogue(5000, seed=4)
    models = [port for port, _ in _pairs(flux, err)] + [
        tnm.DepthNoiseModel(27.0, 3.0), tnm.SpectralNoiseModel(np.ones(7))]
    path = str(tmp_path / "noise.h5")
    with h5py.File(path, "w") as f:
        for i, m in enumerate(models):
            tnm.save_noise_model_hdf5(m, f.create_group(f"m{i}"))
    with h5py.File(path, "r") as f:
        for i, m in enumerate(models):
            for load in (tnm.load_noise_model_hdf5, jnm.load_noise_model_hdf5):
                back = load(f[f"m{i}"])
                assert type(back).__name__ == type(m).__name__
                for name in ("bin_centers", "upper_limit_value", "b_njy",
                             "sigma_njy", "error_type", "sigma_clip",
                             "upper_limit_flux_behaviour"):
                    if hasattr(m, name):
                        a, b = getattr(m, name), getattr(back, name)
                        if isinstance(a, (str, type(None))):
                            assert a == b
                        else:
                            np.testing.assert_array_equal(np.asarray(b), a)
    # JAX-written files, and the reference's class-name aliases
    with h5py.File(path, "w") as f:
        jnm.save_noise_model_hdf5(_pairs(flux, err)[4][1], f.create_group("g"))
        d = f.create_group("ref")
        jnm.DepthNoiseModel(26.0).serialize_to_hdf5(d)
        d.attrs["__class__"] = "DepthUncertaintyModel"
    with h5py.File(path, "r") as f:
        g = tnm.load_noise_model_hdf5(f["g"])
        assert g.upper_limit_flux_behaviour == "upper_limit"
        assert type(tnm.load_noise_model_hdf5(f["ref"])) is tnm.DepthNoiseModel
        f2 = f["g"]
        with pytest.raises(ValueError, match="Unknown noise model"):
            tnm.load_noise_model_hdf5(type("G", (), {"attrs": {
                "__class__": "Nope"}})())
        assert f2.attrs["__class__"] == "GeneralEmpiricalNoiseModel"


def test_feature_pipeline_with_empirical_models():
    rng = np.random.default_rng(7)
    codes = ["A", "B", "C"]
    phot = (10 ** rng.uniform(1, 4, (400, 3))).astype(np.float32)
    theta = rng.uniform(0, 1, (400, 2)).astype(np.float32)
    flux, err = _catalogue(5000, seed=5)
    models = tnm.create_noise_models_from_catalogue(
        {c: flux for c in codes}, {c: err for c in codes}, "general")
    fitter = tt.SBIFitter(phot, theta, ["a", "b"], codes, device="cpu")
    res = fitter.create_feature_array(
        tt.FeatureConfig(filter_codes=tuple(codes), unit="asinh",
                         n_scatters=2, include_errors=True),
        noise_models=models)
    assert res.features.shape == (800, 6) and np.isfinite(res.features).all()
    # the catalogue's σ at each flux, through the model, not a depth
    noisy, sig = models["A"].apply(torch.Generator().manual_seed(0),
                                   torch.as_tensor(phot[:, 0]))
    mu, _ = models["A"].sigma_mean_std(torch.as_tensor(phot[:, 0]))
    assert float(torch.median(sig / mu)) == pytest.approx(1.0, abs=0.1)
