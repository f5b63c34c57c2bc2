"""Port parity, the slice as a whole: `SBIFitter` of both packages on one
library of the port's tiny test model (16 ages × 4 metallicities × 1024 λ, 7
tophat bands; 1500 draws through `LibraryGenerator.generate` on the CPU).

- A JAX `SBIFitter` trains a tiny NSF ensemble and saves it; the port's
  `load_saved_model` reads that file and gives the same `log_prob` (1e-4)
  and, from the base normals the JAX package draws from its key, the same
  samples (1e-4 of each θ column's largest value: peak_age is ~1e9). The other direction too: the port trains and saves,
  `synference_tpu.SBIFitter.load_saved_model` reads the port's file. A
  single member (n_nets = 1) goes both ways as well.
- `features_from_observations` of a loaded model equals the JAX package's
  (rtol 1e-6, float32 transcendental functions).
- The port's own `run_single_sbi` → `evaluate_model` → `evaluate_members`
  runs on the CPU and returns the JAX reports' keys; the held-out split is
  grouped by source galaxy and shuffled.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu.features import FeatureConfig as JFeatureConfig
from synference_tpu.train import TrainConfig as JTrainConfig
from synference_tpu_torch import diagnostics as td

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
PRIOR = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 4.0),
         "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
         "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
_CODES = ["F090W", "F115W", "F150W", "F200W", "F277W", "F356W", "F444W"]
_CENTERS = [9000., 11500., 15000., 20000., 27700., 35600., 44400.]
_WIDTHS = [2000., 2600., 3300., 4600., 7000., 7800., 10200.]
FEATURES = dict(filter_codes=tuple(_CODES), unit="asinh",
                depths_ab=(29.5,) * 7, n_scatters=1, include_errors=True)
MODEL = dict(hidden_features=16, num_transforms=3, num_bins=4)
TRAIN = dict(max_epochs=3, stop_after_epochs=3, batch_size=128,
             learning_rate=2e-3)
ROUNDS = 4


@pytest.fixture(scope="module")
def library():
    grid = tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024)
    filt = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                         zip(_CODES, _CENTERS, _WIDTHS)])
    sim = tt.BatchSEDSimulator(grid, filt, PNAMES, sfh="lognormal",
                               zdist="delta", emission=tt.EmissionConfig(),
                               device="cpu")
    gen = tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                              device="cpu")
    return gen.generate(n=1500, batch_size=256, seed=3, zsorted_fused=True)


def _port_fitter(library):
    fitter = tt.SBIFitter(library["photometry"].T, library["parameters"].T,
                          library["parameter_names"], library["filter_codes"],
                          device="cpu")
    fitter.create_feature_array(tt.FeatureConfig(**FEATURES))
    return fitter


def _jax_fitter(library):
    fitter = jst.SBIFitter(library["photometry"].T, library["parameters"].T,
                           library["parameter_names"],
                           library["filter_codes"])
    fitter.create_feature_array(JFeatureConfig(**FEATURES))
    return fitter


def _ensemble_base(key, k, m, per, dim):
    """The normals `EnsemblePosterior.sample_batch` draws in the JAX
    package: (K, M, ROUNDS·per, D)."""
    return np.stack([np.stack([
        np.concatenate([np.asarray(jax.random.normal(kk, (per, dim)))
                        for kk in jax.random.split(ko, ROUNDS)])
        for ko in jax.random.split(km, m)]) for km in jax.random.split(key, k)])


@pytest.mark.parametrize("n_nets", [2, 1])
def test_port_loads_a_model_the_jax_package_saved(library, tmp_path, n_nets):
    jfit = _jax_fitter(library)
    jfit.run_single_sbi("nsf", n_nets=n_nets,
                        train_config=JTrainConfig(**TRAIN), **MODEL)
    path = str(tmp_path / "jax_model.pkl")
    jfit.save_state(path)
    fitter = tt.SBIFitter.load_saved_model(path, device="cpu")
    assert fitter.parameter_names == list(PNAMES)
    assert fitter.filter_codes == _CODES and fitter.engine == "npe"
    idx = jfit._split["test"][:40]
    xs, truths = jfit.features[idx], jfit.feature_params[idx]
    with torch.no_grad():
        lp = fitter.posterior.log_prob(truths, xs).numpy()
    ref = np.asarray(jfit.posterior.log_prob(jnp.asarray(truths),
                                             jnp.asarray(xs)))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(lp, ref, atol=1e-4)
    key = jax.random.PRNGKey(1)
    n, m = 9, 6
    ref = np.asarray(jfit.posterior.sample_batch(key, jnp.asarray(xs[:m]), n))
    if n_nets == 1:
        # a direct posterior splits the key per object, not per member
        base = np.stack([
            np.concatenate([np.asarray(jax.random.normal(kk, (n, 6)))
                            for kk in jax.random.split(ko, ROUNDS)])
            for ko in jax.random.split(key, m)])
    else:
        base = _ensemble_base(key, n_nets, m, -(-n // n_nets), len(PNAMES))
    with torch.no_grad():
        s = fitter.posterior.sample_batch(xs[:m], n, base=base).numpy()
    assert s.shape == ref.shape == (m, n, len(PNAMES))
    # θ spans 7 decades between its columns (peak_age ~ 1e9): relative
    scale = np.abs(ref).max(axis=(0, 1))
    np.testing.assert_allclose(s / scale, ref / scale, atol=1e-4)
    # the feature transform of the loaded model replays the JAX package's
    flux = library["photometry"].T[:20]
    err = 0.05 * np.abs(flux) + 1.0
    np.testing.assert_allclose(
        fitter.features_from_observations(flux, err),
        jfit.features_from_observations(flux, err), rtol=1e-6)
    np.testing.assert_allclose(
        fitter.features_from_observations(flux / 1e9, err / 1e9, "Jy"),
        jfit.features_from_observations(flux / 1e9, err / 1e9, "Jy"),
        rtol=2e-5)


@pytest.fixture(scope="module")
def trained(library):
    fitter = _port_fitter(library)
    result = fitter.run_single_sbi(
        "nsf", n_nets=3, train_config=tt.TrainConfig(**TRAIN), **MODEL)
    return fitter, result


def test_jax_package_loads_a_model_the_port_saved(trained, tmp_path):
    fitter, _ = trained
    path = str(tmp_path / "port_model.pkl")
    fitter.save_state(path)
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert sorted(state) == sorted([
        "name", "engine", "prior", "parameter_names", "filter_codes",
        "feature_flags", "flow_spec", "params", "n_members",
        "train_history"])
    # plain Python and numpy only

    def plain(v):
        if isinstance(v, dict):
            return all(isinstance(k, str) and plain(x) for k, x in v.items())
        if isinstance(v, (list, tuple)):
            return all(plain(x) for x in v)
        return isinstance(v, (np.ndarray, np.generic, str, int, float, bool,
                              type(None)))

    assert plain(state)
    assert state["params"]["theta_mean"].shape == (3, 6)
    jfit = jst.SBIFitter.load_saved_model(path)
    idx = fitter._split["test"][:40]
    xs, truths = fitter.features[idx], fitter.feature_params[idx]
    with torch.no_grad():
        lp = fitter.posterior.log_prob(truths, xs).numpy()
    ref = np.asarray(jfit.posterior.log_prob(jnp.asarray(truths),
                                             jnp.asarray(xs)))
    np.testing.assert_allclose(ref, lp, atol=1e-4)
    flux = fitter.photometry[:10]
    np.testing.assert_allclose(
        jfit.features_from_observations(flux, 0.1 * flux + 1.0),
        fitter.features_from_observations(flux, 0.1 * flux + 1.0), rtol=1e-6)
    # and back into the port: the same bits
    again = tt.SBIFitter.load_saved_model(path, device="cpu")
    with torch.no_grad():
        assert np.array_equal(again.posterior.log_prob(truths, xs).numpy(),
                              lp)
    assert again.feature_flags == fitter.feature_flags


def test_member_count_comes_from_the_parameters(trained, tmp_path):
    """The mixture's −log K uses the parameters' leading axis; a saved
    state that names another count is refused, not mis-normalised."""
    fitter, _ = trained
    assert fitter.posterior.n_members == 3
    path = str(tmp_path / "model.pkl")
    fitter.save_state(path)
    with open(path, "rb") as f:
        state = pickle.load(f)
    state["n_members"] = 2
    with open(path, "wb") as f:
        pickle.dump(state, f)
    with pytest.raises(ValueError, match="2 members.*carry 3"):
        tt.SBIFitter.load_saved_model(path, device="cpu")


def test_port_runs_train_evaluate_and_members(trained):
    fitter, result = trained
    assert result.val_losses.shape == (3, 3) and result.n_members == 3
    assert np.isfinite(result.val_losses).all()
    assert (result.val_losses[-1] < result.val_losses[0]).all()
    # the split: grouped by source galaxy, shuffled (library rows are
    # sorted by redshift), disjoint
    test, train = fitter._split["test"], fitter._split["train"]
    assert not set(test) & set(train)
    assert len(test) + len(train) == len(fitter.features)
    assert not np.all(np.diff(test) > 0) and not np.all(np.diff(train) > 0)
    report = fitter.evaluate_model(n_samples=32, max_objects=64)
    assert sorted(report) == sorted([
        "point", "pit_ks", "tarp_deviation", "mean_log_prob",
        "mean_log_prob_normalized", "frac_outside_support", "coverage",
        "coverage_levels", "n_samples", "sampling_acceptance_mean",
        "sampling_acceptance_min", "frac_clipped", "parameter_names"])
    assert sorted(report["point"]) == sorted(
        ["mse", "rmse", "mae", "median_ae", "bias", "r2", "nmse"])
    assert report["sampling_acceptance_min"] == 1.0  # support-aware flow
    assert report["parameter_names"] == list(PNAMES)
    assert np.isfinite(report["pit_ks"]).all()
    assert np.asarray(report["coverage"]).shape == (4, 6)
    members = fitter.evaluate_members(n_samples=16, max_objects=32)
    assert sorted(members) == sorted([
        "n_members", "n_samples", "tarp_deviation", "pit_ks_max", "pit_ks",
        "r2", "mean_log_prob", "sampling_acceptance_min", "parameter_names"])
    assert sorted(members["tarp_deviation"]) == ["ci95", "mean", "per_member",
                                                 "std"]
    assert len(members["tarp_deviation"]["per_member"]) == 3
    draws = fitter.sample_posterior(fitter.features[test[:5]], 50)
    assert draws.shape == (5, 50, 6) and isinstance(draws, np.ndarray)
    assert fitter.prior.support_mask(draws.reshape(-1, 6)).all()
    # every sample inside the prior box, which is the library's min/max
    np.testing.assert_array_equal(fitter.prior.low.numpy(),
                                  fitter.feature_params.min(axis=0))


def test_single_member_without_support_and_unported_engines(library):
    fitter = _port_fitter(library)
    fitter.run_single_sbi(
        "nsf", n_nets=1, support_aware=False,
        train_config=tt.TrainConfig(max_epochs=1, batch_size=256), **MODEL)
    assert isinstance(fitter.posterior, tt.DirectPosterior)
    assert "support_low" not in fitter.flow.config
    assert fitter.posterior.params["theta_mean"].shape == (6,)
    report = fitter.evaluate_model(n_samples=16, max_objects=16)
    assert 0.0 <= report["sampling_acceptance_min"] <= 1.0
    with pytest.raises(ValueError, match="n_nets>1"):
        fitter.evaluate_members()
    for engine, item in (("nle", "M11"), ("nre", "M13")):
        with pytest.raises(NotImplementedError, match=item):
            fitter.run_single_sbi(engine=engine)
    with pytest.raises(ValueError, match="unknown engine"):
        fitter.run_single_sbi(engine="abc")
    with pytest.raises(NotImplementedError, match="ROADMAP M11"):
        fitter.run_single_sbi("maf", train_config=tt.TrainConfig(max_epochs=1))
    # missing-band replay is ported: a mask sets flux and error columns
    feats = fitter.features_from_observations(
        fitter.photometry[:2], fitter.photometry[:2],
        missing_mask=np.eye(2, 7))
    assert feats.shape == (2, 14)
    assert feats[0, 0] == feats[0, 7] == feats[1, 1] == 99.0
    assert (feats[:, 2:7] != 99.0).all()


def test_no_fallback_to_the_cpu_without_a_card(library, tmp_path):
    """Asked for "cuda" where there is no card, every entry point raises
    (nothing carries on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from synference_tpu_torch.flows.base import build_flow

    errors = (RuntimeError, AssertionError)
    with pytest.raises(errors):
        tt.SBIFitter(library["photometry"].T, library["parameters"].T,
                     library["parameter_names"], library["filter_codes"],
                     device="cuda")
    with pytest.raises(errors):
        build_flow("nsf", 2, 3, device="cuda", **MODEL)
    with pytest.raises(errors):
        tt.BoxUniform([0.0], [1.0], device="cuda")
    with pytest.raises(errors):
        tt.priors_from_library(library["parameters"], PNAMES, device="cuda")
    samples = np.zeros((4, 8, 2), np.float32)
    truths = np.zeros((4, 2), np.float32)
    for metric in (td.pit_values, td.sbc_ranks, td.tarp_coverage,
                   td.tarp_deviation, td.expected_coverage,
                   td.point_metrics):
        with pytest.raises(errors):
            metric(samples, truths, device="cuda")
        with pytest.raises(TypeError, match="device"):
            metric(samples, truths)
    with pytest.raises(errors):
        td.pit_ks_statistic(truths, device="cuda")
    fitter = _port_fitter(library)
    fitter.run_single_sbi(
        "nsf", n_nets=1, train_config=tt.TrainConfig(max_epochs=1,
                                                     batch_size=512), **MODEL)
    path = str(tmp_path / "m.pkl")
    fitter.save_state(path)
    with pytest.raises(errors):
        tt.SBIFitter.load_saved_model(path, device="cuda")
    with pytest.raises(errors):
        fitter.feature_pipeline.transform_observations(
            fitter.photometry[:2], fitter.photometry[:2], device="cuda")


def test_init_from_hdf5_of_a_jax_library(tmp_path):
    """`init_from_hdf5` on a library file the JAX package wrote (with
    supplementary columns): the same arrays and names as the JAX package's
    fitter; a feature config that moves a supplementary column into θ and
    transforms another renames the fitted parameters as there."""
    supp = ("m_uv", "sfr_100", "mass_weighted_age", "t50")
    grid = jst.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024)
    filt = jst.FilterSet([jst.tophat_filter(c, ct, w) for c, ct, w in
                          zip(_CODES, _CENTERS, _WIDTHS)])
    sim = jst.BatchSEDSimulator(grid, filt, PNAMES, photometry_backend="xla")
    path = str(tmp_path / "jax_library.h5")
    jst.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                         supplementary=supp).generate(
        n=200, batch_size=128, seed=2, out_path=path)
    fitter = tt.SBIFitter.init_from_hdf5(path, device="cpu")
    ref = jst.SBIFitter.init_from_hdf5(path)
    assert fitter.name == ref.name == "jax_library"
    assert fitter.parameter_names == ref.parameter_names == list(PNAMES)
    assert fitter.filter_codes == ref.filter_codes == _CODES
    assert fitter.supplementary_names == ref.supplementary_names == list(supp)
    for attr in ("photometry", "parameters", "supplementary"):
        np.testing.assert_array_equal(getattr(fitter, attr),
                                      getattr(ref, attr))
    kw = dict(FEATURES, depths_ab=None, remove_parameters=("tau",),
              add_parameters=("sfr_100",),
              parameter_transforms=(("sfr_100", "log10"),),
              extra_features=("t50",))
    res = fitter.create_feature_array(tt.FeatureConfig(**kw))
    jres = ref.create_feature_array(JFeatureConfig(**kw))
    assert fitter.parameter_names == ref.parameter_names
    assert fitter.parameter_names[-1] == "log10_sfr_100"
    assert res.feature_names == jres.feature_names
    np.testing.assert_allclose(res.features, jres.features, rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(fitter.feature_params, ref.feature_params,
                               rtol=1e-6)
    prior = fitter.create_priors()
    assert prior.names == tuple(fitter.parameter_names)


def test_from_library_dict_matches_init_from_hdf5(library, tmp_path):
    path = str(tmp_path / "port.h5")
    tt.save_library_hdf5(path, parameters=library["parameters"],
                         parameter_names=library["parameter_names"],
                         photometry=library["photometry"],
                         filter_codes=library["filter_codes"])
    a = tt.SBIFitter.from_library(library, device="cpu")
    b = tt.SBIFitter.init_from_hdf5(path, name="named", device="cpu")
    assert b.name == "named" and a.supplementary is None
    np.testing.assert_array_equal(a.photometry, b.photometry)
    np.testing.assert_array_equal(a.parameters, b.parameters)
