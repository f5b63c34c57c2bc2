"""Port parity, the spectroscopic front end: `spectra.py` (constant-R grid,
both resamplers, the Gaussian LSF and its bank, `SpectralFeaturePipeline`)
against the JAX package's on the same numpy spectra, then
`LibraryGenerator(spectral_pipeline=...)` and
`SBIFitter.create_feature_array_from_raw_spectra` against theirs.

Setup: the 32×5×512 test grid (log-uniform, grid R ≈ 56) and a 24×4×2048
grid for the pipeline (grid R ≈ 226), an R = 100 prism-like grid over
6000-53000 Å, redshifts 0.05-6.

Tolerances, on values above 1e-3 of their row's maximum:
- the pipeline, the linear resampler and the LSF on identical inputs:
  max relative < 1e-5; the appended log10 norm absolute < 1e-6 (it sits
  near zero, where a relative bound means nothing);
- the flux-conserving resampler differences a cumulative integral: the
  port takes it in float64 and lies < 1e-5 from a float64 numpy oracle;
  the JAX package takes it in float32 and lies up to 3.6e-3 from the same
  oracle (measured), so port against JAX is held at 1e-2;
- raw-spectra features with the JAX noise normals passed in: max relative
  < 1e-5, the log10 norm absolute < 1e-6;
- library spectra end to end from θ, the JAX tables loaded: |Δ| < 1e-4 of
  the row's largest value (the dense path's rule for CDF-difference bins).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu import spectra as jsp
from synference_tpu.fitter import SBIFitter as JFitter
from synference_tpu.noise_models import SpectralNoiseModel as JSpectralNoise
from synference_tpu_torch import spectra as tsp

from test_torch_dense import _jax_state

PRIOR = {"log10_mass": (8.0, 11.0), "redshift": (0.5, 6.0),
         "log10_peak_age": (7.8, 9.2), "tau": (0.1, 1.0),
         "log10_metallicity": (-3.5, -1.8), "tau_v": (0.0, 1.5)}
PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    rel = np.abs(port - ref) / np.maximum(np.abs(ref), 1e-30)
    return rel[np.abs(ref) > 1e-3 * np.abs(ref).max(axis=-1, keepdims=True)]


def _close_features(port, ref, norm: bool, rtol=1e-5):
    """Spectral features against the JAX package's: relative on the pixels,
    absolute on the appended log10 norm (at the pixels' bound, as a log)."""
    port, ref = np.asarray(port), np.asarray(ref)
    if norm:
        assert np.abs(port[:, -1] - ref[:, -1]).max() < max(1e-6, rtol / 2)
        port, ref = port[:, :-1], ref[:, :-1]
    assert _rel(port, ref).max() < rtol


def _conserve64(new, lam, flux):
    """float64 numpy oracle of the flux-conserving resampler, one row."""
    def edges(grid):
        mid = 0.5 * (grid[1:] + grid[:-1])
        return np.concatenate([[grid[0] - (mid[0] - grid[0])], mid,
                               [grid[-1] + (grid[-1] - mid[-1])]])
    e_in = edges(lam.astype(np.float64))
    e_out = edges(new.astype(np.float32).astype(np.float64))
    c = np.concatenate([[0.0], np.cumsum(flux.astype(np.float64)
                                         * np.diff(e_in))])
    return np.diff(np.interp(e_out, e_in, c)) / np.diff(e_out)


def _spectra(n=16, n_wav=512, seed=0):
    """Rest λ grid and smooth positive spectra with a few sharp lines."""
    lam = jst.make_synthetic_grid(n_ages=4, n_mets=2, n_wav=n_wav).lam
    rng = np.random.default_rng(seed)
    slope = rng.uniform(-2.5, 0.5, (n, 1))
    flux = (lam[None, :] / 5000.0) ** slope
    for _ in range(5):
        j = rng.integers(10, n_wav - 10, n)
        flux[np.arange(n), j] += rng.uniform(1, 20, n)
    z = rng.uniform(0.05, 6.0, n).astype(np.float32)
    return lam, flux.astype(np.float32), z


def test_constant_r_grid_and_resamplers():
    np.testing.assert_array_equal(
        tsp.generate_constant_r_grid(100, 6000.0, 53000.0),
        jsp.generate_constant_r_grid(100, 6000.0, 53000.0))
    lam, flux, z = _spectra()
    new = tsp.generate_constant_r_grid(100, 6000.0, 53000.0)
    lam_obs = (lam[None, :] * (1 + z[:, None])).astype(np.float32)
    port = tsp.resample_spectrum(new, lam_obs, flux)
    ref = np.stack([np.asarray(jsp.resample_spectrum(new, lam_obs[i],
                                                     flux[i]))
                    for i in range(len(z))])
    assert _rel(port, ref).max() < 1e-5
    one = tsp.resample_spectrum(new, lam_obs[0], flux[0])
    np.testing.assert_array_equal(one.numpy(), port[0].numpy())
    # flux conserving: against a float64 oracle and the JAX package; ∫f dλ
    # kept
    port = tsp.resample_spectrum_conserve(new, lam_obs, flux)
    ref = np.stack([np.asarray(jsp.resample_spectrum_conserve(
        new, lam_obs[i], flux[i])) for i in range(len(z))])
    oracle = np.stack([_conserve64(new, lam_obs[i], flux[i])
                       for i in range(len(z))])
    assert _rel(port, oracle).max() < 1e-5
    assert _rel(port, ref).max() < 1e-2
    # a coarser output grid over the same span keeps the line fluxes
    coarse = lam[2:-2:4]
    kept = tsp.resample_spectrum_conserve(coarse, lam, flux[0]).numpy()
    assert _rel(kept[None], _conserve64(coarse, lam, flux[0])[None]).max() \
        < 1e-5


def test_lsf_constant_and_curve():
    lam, flux, _ = _spectra(n_wav=2048)
    grid_r = float(0.5 / np.expm1(np.log(lam[1] / lam[0])))
    port = tsp.match_resolution_constant_r(flux, 10 * grid_r, 100.0, grid_r)
    ref = jsp.match_resolution_constant_r(flux, 10 * grid_r, 100.0, grid_r)
    assert _rel(port, ref).max() < 1e-5
    same = tsp.match_resolution_constant_r(flux, 50.0, 100.0, grid_r)
    np.testing.assert_array_equal(same.numpy(), flux)
    curve_lam = np.array([5000.0, 20000.0, 60000.0])
    curve_r = np.array([30.0, 100.0, 300.0])
    port = tsp.match_resolution_curve(flux, lam, 10 * grid_r, curve_lam,
                                      curve_r, grid_r)
    ref = jsp.match_resolution_curve(flux, lam, 10 * grid_r, curve_lam,
                                     curve_r, grid_r)
    assert _rel(port, ref).max() < 1e-5
    one = tsp.match_resolution_curve(flux[0], lam, 10 * grid_r, curve_lam,
                                     curve_r, grid_r)
    np.testing.assert_allclose(one.numpy(), port[0].numpy(), rtol=1e-6)


@pytest.mark.parametrize("norm,conserve", [(None, False),
                                           ((20000.0, 30000.0), False),
                                           ((20000.0, 30000.0), True)])
def test_pipeline_matches_jax(norm, conserve):
    lam, flux, z = _spectra(n=24, n_wav=2048, seed=1)
    obs = tsp.generate_constant_r_grid(100, 6000.0, 53000.0)
    kw = dict(instrument_r=100.0, norm_window=norm, flux_conserving=conserve)
    port = tsp.SpectralFeaturePipeline(lam, obs, device="cpu", **kw)(flux, z)
    ref = jsp.SpectralFeaturePipeline(lam, obs, **kw)(flux, z)
    assert port.shape == (24, len(obs) + (norm is not None))
    _close_features(port, ref, norm is not None,
                    rtol=1e-2 if conserve else 1e-5)
    with pytest.raises(ValueError, match="log-uniform"):
        tsp.SpectralFeaturePipeline(np.linspace(1e3, 1e4, 50), obs,
                                    device="cpu")


@functools.lru_cache(maxsize=None)
def _gens():
    out = []
    for pkg in (jst, tt):
        grid = pkg.make_synthetic_grid(n_ages=24, n_mets=4, n_wav=2048)
        filt = pkg.FilterSet([pkg.tophat_filter("F200W", 20000.0, 4600.0)])
        kw = dict(device="cpu") if pkg is tt else {}
        sim = pkg.BatchSEDSimulator(grid, filt, PNAMES, sfh="lognormal",
                                    zdist="delta",
                                    emission=pkg.EmissionConfig(),
                                    photometry_backend="xla", **kw)
        sp = tsp if pkg is tt else jsp
        obs = sp.generate_constant_r_grid(100, 6000.0, 53000.0)
        pipe = sp.SpectralFeaturePipeline(
            grid.lam, obs, instrument_r=100.0, norm_window=(20000.0, 30000.0),
            **kw)
        out.append(pkg.LibraryGenerator(sim, PRIOR,
                                        unlog_keys=["log10_peak_age"],
                                        spectral_pipeline=pipe, **kw))
    out[1].simulator.load_state(_jax_state(out[0].simulator))
    return out


def test_library_spectra_through_pipeline(tmp_path):
    jgen, tgen = _gens()
    port = tgen.generate(96, batch_size=64, want_spectra=True, seed=4)
    ref = jgen.generate(96, batch_size=64, want_spectra=True, seed=4)
    np.testing.assert_array_equal(port["parameters"], ref["parameters"])
    np.testing.assert_array_equal(port["wavelengths"],
                                  np.asarray(ref["wavelengths"]))
    assert port["spectra"].shape == ref["spectra"].shape == (
        len(port["wavelengths"]) + 1, 96)
    # the pipeline itself on identical inputs, on one batch
    theta = port["parameters"].T[:64]
    fnu = tgen.simulator.simulate(theta, want_spectra=True)["fnu_njy"]
    z = theta[:, 1]
    _close_features(tgen.spectral_pipeline(fnu, z),
                    jgen.spectral_pipeline(fnu.numpy(), z), True)
    p, r = port["spectra"].T[:, :-1], np.asarray(ref["spectra"]).T[:, :-1]
    assert (np.abs(p - r) / np.abs(r).max(1, keepdims=True)).max() < 1e-4
    empty = tgen.generate(0, want_spectra=True)
    assert empty["spectra"].shape == (len(port["wavelengths"]), 0)
    if _has_h5py():
        path = str(tmp_path / "spec.h5")
        tgen.generate(96, batch_size=64, want_spectra=True, seed=4,
                      out_path=path)
        for loaded in (tt.load_library_hdf5(path),
                       jst.library.load_library_hdf5(path)):
            np.testing.assert_array_equal(loaded["wavelengths"],
                                          port["wavelengths"])
            np.testing.assert_array_equal(loaded["spectra"], port["spectra"])


def _has_h5py():
    import importlib.util

    return importlib.util.find_spec("h5py") is not None


@pytest.mark.parametrize("normalize", [None, 40, ("tophat", 25000.0, 8000.0),
                                       ("bandpass", 20000.0, 30000.0), "fn"])
def test_raw_spectra_features_match_jax(normalize):
    rng = np.random.default_rng(8)
    n, obs = 48, tsp.generate_constant_r_grid(100, 6000.0, 53000.0)
    spec = (10 ** rng.uniform(0, 2, (n, 1))
            * (obs[None, :] / 2e4) ** rng.uniform(-2, 1, (n, 1))).astype(
                np.float32)
    theta = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    kern = (0.02 * np.median(spec, axis=0)).astype(np.float32)
    if normalize == "fn":
        def normalize(s, lam):
            return s[:, 10:20].mean(-1)
    kw = dict(n_scatters=2, crop_lam=(7000.0, 50000.0), normalize=normalize)
    jf = JFitter(np.zeros((n, 1)), theta, ["a", "b", "c"], ["F"],
                 spectra=spec, wavelengths=obs)
    tf = tt.SBIFitter(np.zeros((n, 1)), theta, ["a", "b", "c"], ["F"],
                      spectra=spec, wavelengths=obs, device="cpu")
    i0, i1 = np.searchsorted(obs, (7000.0, 50000.0))
    key = jax.random.PRNGKey(2)
    g = np.asarray(jax.random.normal(key, (2 * n, i1 - i0)))
    ref = jf.create_feature_array_from_raw_spectra(
        noise_model=JSpectralNoise(kern[i0:i1]), key=key, **kw)
    port = tt.SBIFitter.create_feature_array_from_raw_spectra(
        tf, noise_model=tt.SpectralNoiseModel(kern[i0:i1]),
        draws={"g": g}, **kw)
    assert port.shape == ref.shape
    _close_features(port, ref, normalize is not None)
    np.testing.assert_array_equal(tf.feature_params, jf.feature_params)
    np.testing.assert_array_equal(tf.feature_source, jf.feature_source)
    assert tf.feature_flags["crop"] == jf.feature_flags["crop"]
    # noiseless, pixel-cropped, from the generator
    plain = tf.create_feature_array_from_raw_spectra(crop=(3, 50))
    np.testing.assert_array_equal(plain, spec[:, 3:50])
    with pytest.raises(ValueError, match="unknown normalize"):
        tf.create_feature_array_from_raw_spectra(normalize=("box", 1, 2))


def test_embedding_fitter_saved_model_both_ways(tmp_path):
    """Raw-spectra features, an NSF with an embedding net trained by the
    fitter, `save_state`, and the saved model read back: by the port bit for
    bit, and its flow spec and parameters by the JAX package's
    `ConditionalFlow` to the NSF's bound (1e-4). (The JAX package's
    `load_saved_model` cannot rebuild a fitter with spectral feature flags,
    its own files included: it replays them as a photometric pipeline; the
    port's skips the pipeline for them.)"""
    rng = np.random.default_rng(9)
    n, obs = 256, tsp.generate_constant_r_grid(100, 6000.0, 53000.0)
    theta = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    spec = (10 ** (1 + theta[:, :1]) * (obs[None, :] / 2e4)
            ** (theta[:, 1:] - 1.5)).astype(np.float32)
    fitter = tt.SBIFitter(np.zeros((n, 1)), theta, ["a", "b"], ["F"],
                          spectra=spec, wavelengths=obs, device="cpu")
    fitter.create_feature_array_from_raw_spectra(
        noise_model=tt.SpectralNoiseModel(0.01 * spec.mean(0)),
        normalize=("bandpass", 20000.0, 30000.0))
    fitter.run_single_sbi("nsf", hidden_features=8, num_transforms=2,
                          embedding_dim=4, embedding_hidden=8,
                          train_config=tt.TrainConfig(max_epochs=1,
                                                      batch_size=64))
    assert fitter.flow.spec()["config"]["embedding_dim"] == 4
    assert "embed" in fitter.posterior.params
    path = str(tmp_path / "spec_model.pkl")
    fitter.save_state(path)
    xs, truths = fitter.features[:32], fitter.feature_params[:32]
    with torch.no_grad():
        lp = fitter.posterior.log_prob(truths, xs).numpy()
    import pickle

    from synference_tpu.flows.base import ConditionalFlow as JFlow

    with open(path, "rb") as f:
        state = pickle.load(f)
    jflow = JFlow.from_spec(state["flow_spec"])
    member = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                    state["params"])
    with torch.no_grad():
        flp = fitter.flow.log_prob(fitter.posterior.params, truths, xs)
    np.testing.assert_allclose(
        flp.numpy(), np.asarray(jflow.log_prob(member, truths, xs)),
        atol=1e-4)
    again = tt.SBIFitter.load_saved_model(path, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(
            again.posterior.log_prob(truths, xs).numpy(), lp)
