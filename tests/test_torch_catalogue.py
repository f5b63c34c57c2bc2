"""Port parity, `catalogue.py` against the JAX package.

- OOD scores on shared float64 arrays: Mahalanobis distances (float32 in
  both packages) to 1e-4 relative; ECOD, HBOS, kNN and PCA (float64 in
  both) to 1e-9 relative; `ood_vote` flags equal for all eight methods
  (isolation forest, LOF and the elliptic envelope are scikit-learn in
  both); feature contributions (float32) to 1e-4.
- `MissingPhotometryHandler.impute` with the neighbour ranks and jitter
  normals the JAX package draws from its key, passed in: 1e-5 relative.
- `fit_catalogue` of both packages' fitters (the same flow weights, feature
  pipeline and training features) with the posterior's base normals the
  JAX package draws from its key passed in as `base=`: quantile columns to
  1e-4 of each parameter's range, with and without missing bands pooled
  over imputations; reconstructed photometry and SED bands from a simulator
  on the same draws to 1e-4 of the row maximum (both exact routes).
- `fit_catalogue_table`: a DataFrame in, the columns appended, the CSV
  read back.
- A missing scikit-learn raises ImportError naming the method; the vote
  never runs over fewer methods.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu import catalogue as jcat
from synference_tpu import posterior as jpost
from synference_tpu import priors as jpriors
from synference_tpu.features import FeatureConfig as JConfig
from synference_tpu.features import FeaturePipeline as JPipeline
from synference_tpu.flows import base as jbase
from synference_tpu_torch import catalogue as tcat
from synference_tpu_torch.flows import base as tbase

CODES = ("F090W", "F150W", "F200W", "F277W", "F444W")
CENTERS = (9000.0, 15000.0, 20000.0, 27700.0, 44400.0)
WIDTHS = (2000.0, 3300.0, 4600.0, 7000.0, 10200.0)
PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
LOW = (7.5, 0.1, 4e7, 0.1, -3.9, 0.0)
HIGH = (11.0, 4.0, 1.6e9, 1.2, -1.6, 2.0)
ROUNDS = 4


@pytest.fixture(scope="module")
def arrays():
    """Train/test feature arrays: a correlated Gaussian cloud and a test
    set with outliers."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 5))
    train = rng.standard_normal((600, 5)) @ a + rng.uniform(-2, 2, 5)
    test = rng.standard_normal((80, 5)) @ a
    test[:10] += rng.uniform(6, 12, (10, 5))
    return train, test


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


def test_mahalanobis_matches_jax(arrays):
    train, test = arrays
    flag, dist = tcat.mahalanobis_ood(train, test, device="cpu")
    jflag, jdist = jcat.mahalanobis_ood(train, test)
    assert _rel(dist, jdist).max() < 1e-4
    np.testing.assert_array_equal(flag, jflag)
    assert flag[:10].all()


@pytest.mark.parametrize("method", ["ecod", "hbos", "knn", "pca"])
def test_score_methods_match_jax_in_float64(arrays, method):
    train, test = arrays
    fn = {"ecod": jcat._ecod_scores, "hbos": jcat._hbos_scores,
          "knn": jcat._knn_scores, "pca": jcat._pca_scores}[method]
    ref = fn(train, test)
    got = tcat._SCORE_METHODS[method](torch.as_tensor(train),
                                      torch.as_tensor(test))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        assert _rel(g.numpy(), r).max() < 1e-9, _rel(g.numpy(), r).max()
    flags = tcat._flag_by_train_quantile(got[0], got[1], 0.02).numpy()
    np.testing.assert_array_equal(
        flags, jcat._flag_by_train_quantile(ref[0], ref[1], 0.02))


def test_hbos_edge_cases_match_jax():
    """A constant column (np.histogram widens it by ±0.5) and test values
    on and outside the edges."""
    rng = np.random.default_rng(1)
    train = np.stack([rng.uniform(0, 1, 300), np.full(300, 2.0)], axis=1)
    test = np.array([[0.0, 2.0], [train[:, 0].max(), 2.0], [-1.0, 2.5],
                     [2.0, 1.4], [0.5, 2.6]])
    ref = jcat._hbos_scores(train, test)
    got = tcat._hbos_scores(torch.as_tensor(train), torch.as_tensor(test))
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r).max() < 1e-9


def test_quantile_is_numpys():
    rng = np.random.default_rng(2)
    for n in (1, 2, 7, 1000):
        v = rng.standard_normal(n)
        for q in (0.0, 0.02, 0.5, 0.9, 0.98, 1.0):
            assert float(tcat._quantile(torch.as_tensor(v), q)) == \
                np.quantile(v, q)


def test_ood_vote_matches_jax(arrays):
    train, test = arrays
    flags, votes = tcat.ood_vote(train, test, device="cpu")
    jflags, jvotes = jcat.ood_vote(train, test)
    np.testing.assert_array_equal(votes, jvotes)
    np.testing.assert_array_equal(flags, jflags)
    assert flags[:10].all() and votes.shape == (8, 80)


@pytest.mark.parametrize("method", ["mahalanobis", "robust_mahalanobis",
                                    "standardized_euclidean"])
def test_feature_contributions_match_jax(arrays, method):
    train, test = arrays
    got = tcat.ood_feature_contributions(train, test, method=method,
                                         device="cpu")
    ref = jcat.ood_feature_contributions(train, test, method=method)
    for key in ("feature_contributions", "total_distances",
                "feature_importance"):
        scale = np.abs(ref[key]).max()
        assert np.abs(got[key] - ref[key]).max() < 1e-4 * scale, key
    np.testing.assert_array_equal(got["outlier_mask"], ref["outlier_mask"])
    assert got["threshold"] == ref["threshold"]


def test_compare_methods_matches_jax(arrays):
    train, test = arrays
    got = tcat.compare_methods_feature_importance(train, test, device="cpu")
    ref = jcat.compare_methods_feature_importance(train, test)
    assert got["agreement"] == pytest.approx(ref["agreement"], abs=1e-9)


def test_missing_sklearn_raises_and_never_shrinks_the_vote(arrays,
                                                           monkeypatch):
    train, test = arrays
    monkeypatch.setitem(sys.modules, "sklearn.ensemble", None)
    with pytest.raises(ImportError, match="'iforest' needs scikit-learn"):
        tcat.ood_vote(train, test, device="cpu")
    flags, votes = tcat.ood_vote(train, test, methods=("lof", "pca"),
                                 device="cpu")
    assert votes.shape == (2, 80)
    with pytest.raises(ValueError, match="unknown OOD"):
        tcat.ood_vote(train, test, methods=("pca", "nope"), device="cpu")


# -- imputation --------------------------------------------------------------
@pytest.fixture(scope="module")
def photometry():
    rng = np.random.default_rng(3)
    lib = rng.lognormal(2.0, 1.0, (500, 5)).astype(np.float32)
    lib[:, 1:] *= lib[:, :1] ** 0.3  # correlated bands
    obs = lib[:12] * rng.uniform(0.9, 1.1, (12, 5)).astype(np.float32)
    err = (0.05 * obs + 0.1).astype(np.float32)
    miss = np.zeros_like(obs)
    miss[::2, 1] = 1.0
    miss[1::3, 3] = 1.0
    obs[miss == 1.0] = np.nan  # placeholders must not poison the χ²
    return lib, obs, err, miss


def _jax_kde_draws(key, handler, flux, err, miss):
    """The neighbour ranks and jitter normals `impute` draws from `key` in
    the JAX package (its weights from the port, the same to 1e-6)."""
    key, _ = jax.random.split(key)
    idx, neg = handler.neighbours(*(torch.as_tensor(a) for a in (
        flux, np.maximum(err, 1e-3), miss)))
    w = torch.softmax(0.5 * neg, dim=1).numpy()
    comp, jitter = [], []
    for k, wi in zip(jax.random.split(key, flux.shape[0]), w):
        k1, k2 = jax.random.split(k)
        comp.append(np.asarray(jax.random.categorical(
            k1, jnp.log(jnp.maximum(wi, 1e-12)), shape=(handler.nmc,))))
        jitter.append(np.asarray(jax.random.normal(
            k2, (handler.nmc, flux.shape[1]))))
    return np.stack(comp), np.stack(jitter)


def test_impute_matches_jax_with_draws_passed_in(photometry):
    lib, obs, err, miss = photometry
    handler = tcat.MissingPhotometryHandler(lib, k_neighbors=16, nmc=8,
                                            device="cpu")
    ref_h = jcat.MissingPhotometryHandler(lib, k_neighbors=16, nmc=8)
    key = jax.random.PRNGKey(4)
    comp, jitter = _jax_kde_draws(key, handler, obs, err, miss)
    got, sig = handler.impute(None, obs, err, miss, return_errors=True,
                              comp=comp, jitter=jitter)
    ref, rsig = ref_h.impute(key, obs, err, miss, return_errors=True)
    assert got.shape == (12, 8, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(sig.numpy(), np.asarray(rsig), rtol=1e-5)
    valid = np.broadcast_to(miss[:, None, :] == 0, got.shape)
    np.testing.assert_array_equal(
        got.numpy()[valid], np.broadcast_to(obs[:, None, :], got.shape)[
            valid])


def test_impute_blocks_and_noise_models(photometry, monkeypatch):
    """Object blocks of the χ² search give the same neighbours as one
    block; with noise models the missing bands are rescattered and take the
    model's σ."""
    lib, obs, err, miss = photometry
    handler = tcat.MissingPhotometryHandler(lib, k_neighbors=16, nmc=8,
                                            device="cpu")
    whole = handler.neighbours(*(torch.as_tensor(a) for a in (obs, err,
                                                              miss)))
    monkeypatch.setattr(tcat, "_CHI2_BLOCK", 500 * 5 * 5)  # 5 objects
    blocked = handler.neighbours(*(torch.as_tensor(a) for a in (obs, err,
                                                                miss)))
    assert torch.equal(whole[0], blocked[0])
    noise = [None, tt.DepthNoiseModel(27.0), None, tt.DepthNoiseModel(27.0),
             None]
    noisy = tcat.MissingPhotometryHandler(lib, k_neighbors=16, nmc=64,
                                          noise_models=noise, device="cpu")
    imp, sig = noisy.impute(torch.Generator().manual_seed(0), obs, err, miss,
                            return_errors=True)
    s = noise[1].sigma_njy
    hit = np.broadcast_to(miss[:, None, :] == 1, imp.shape)
    np.testing.assert_allclose(sig.numpy()[hit], s, rtol=1e-6)
    assert np.isfinite(imp.numpy()).all()
    with pytest.raises(ValueError, match="one entry per band"):
        tcat.MissingPhotometryHandler(lib, noise_models=noise[:2],
                                      device="cpu")


# -- fit_catalogue -------------------------------------------------------------
class _Fitter:
    """What `fit_catalogue` reads of a fitter, for either package."""

    def __init__(self, pipeline, posterior, features, device=None):
        self.pipeline, self.posterior = pipeline, posterior
        self.features, self.device = features, device
        self.parameter_names = list(PNAMES)
        self.filter_codes = list(CODES)

    def features_from_observations(self, flux, flux_err=None,
                                   flux_unit="nJy", missing_mask=None):
        kw = {} if self.device is None else {"device": self.device}
        return self.pipeline.transform_observations(
            flux, flux_err, flux_unit, missing_mask, **kw)


@pytest.fixture(scope="module")
def fitters(photometry):
    lib, _, _, _ = photometry
    cfg = dict(filter_codes=CODES, unit="asinh", include_errors=True)
    port_pipe = tt.FeaturePipeline(tt.FeatureConfig(**cfg))
    jax_pipe = JPipeline(JConfig(**cfg))
    feats = jax_pipe.transform_observations(lib, 0.05 * lib + 0.1)
    flow_kw = dict(hidden_features=8, num_transforms=1, num_bins=4,
                   support_low=LOW, support_high=HIGH)
    jflow = jbase.build_flow("nsf", 6, feats.shape[1], **flow_kw)
    flow = tbase.build_flow("nsf", 6, feats.shape[1], device="cpu", **flow_kw)
    rng = np.random.default_rng(5)
    theta = rng.uniform(LOW, HIGH, (64, 6)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jflow.init(
        jax.random.PRNGKey(0), theta, feats[:64]))
    for block in params["flow"]["blocks"]:
        w = block[-1]["w"]
        block[-1]["w"] = (0.1 * rng.standard_normal(w.shape)).astype(
            np.float32)
    ref = _Fitter(jax_pipe, jpost.DirectPosterior(
        jflow, jax.tree_util.tree_map(jnp.asarray, params),
        jpriors.BoxUniform(LOW, HIGH)), feats)
    port = _Fitter(port_pipe, tt.DirectPosterior(
        flow, tbase.params_from_numpy(params, "cpu"),
        tt.BoxUniform(LOW, HIGH, device="cpu")), feats, device="cpu")
    return port, ref


def _direct_base(key, m, n):
    """The normals `DirectPosterior.sample_batch_with_acceptance` draws in
    the JAX package: (M, ROUNDS·n, D)."""
    return np.stack([np.concatenate([
        np.asarray(jax.random.normal(kk, (n, 6)))
        for kk in jax.random.split(k, ROUNDS)])
        for k in jax.random.split(key, m)])


def _close_columns(got, ref, names):
    for name in names:
        span = np.ptp(ref[name]) if np.ptp(ref[name]) > 0 else 1.0
        assert np.abs(got[name] - ref[name]).max() < 1e-4 * max(
            span, np.abs(ref[name]).max()), name


def _quantile_names():
    return [f"{p}_q{q}" for p in PNAMES for q in (16, 50, 84)]


def test_fit_catalogue_matches_jax(fitters, photometry):
    port, ref = fitters
    lib, obs, err, _ = photometry
    # 48 objects and 3 draws each: the shapes of the pooled test below, so
    # that the JAX package's eager sampling compiles once for both
    flux = np.concatenate([lib[100:146], np.full((2, 5), 1e7, np.float32)])
    ferr = 0.05 * flux + 0.1
    key = jax.random.PRNGKey(6)
    methods = ("mahalanobis", "ecod", "hbos", "knn", "pca")
    got = tt.fit_catalogue(port, flux, ferr, n_samples=3, ood_methods=methods,
                           base=_direct_base(key, 48, 3))
    want = jcat.fit_catalogue(ref, flux, ferr, n_samples=3,
                              ood_methods=methods, key=key)
    _close_columns(got, want, _quantile_names())
    np.testing.assert_array_equal(got["flag_ood"], want["flag_ood"])
    np.testing.assert_array_equal(got["ood_votes"], want["ood_votes"])
    assert got["flag_ood"][-2:].all()
    np.testing.assert_allclose(got["sampling_acceptance"],
                               want["sampling_acceptance"], atol=1e-7)
    np.testing.assert_allclose(got["_features"], want["_features"],
                               rtol=2e-5, atol=1e-5)


def test_fit_catalogue_pools_imputations_like_jax(fitters, photometry):
    port, ref = fitters
    lib, obs, err, miss = photometry
    nmc, n = 4, 12
    handler = tcat.MissingPhotometryHandler(lib, k_neighbors=16, nmc=nmc,
                                            device="cpu")
    ref_h = jcat.MissingPhotometryHandler(lib, k_neighbors=16, nmc=nmc)
    key = jax.random.PRNGKey(7)
    k_imp, k_samp = jax.random.split(key)
    comp, jitter = _jax_kde_draws(k_imp, handler, obs, err, miss)
    per = -(-n // nmc)
    base = _direct_base(k_samp, obs.shape[0] * nmc, per)

    def process(generator, posterior, feature_fn, *args, **kw):
        return tcat.MissingPhotometryHandler.process_observations(
            handler, generator, posterior, feature_fn, *args, comp=comp,
            jitter=jitter, base=base)

    handler.process_observations = process
    got = tt.fit_catalogue(port, obs, err, missing_mask=miss, n_samples=n,
                           check_ood=False, missing_data_handler=handler)
    want = jcat.fit_catalogue(ref, obs, err, missing_mask=miss, n_samples=n,
                              check_ood=False,
                              missing_data_handler=ref_h, key=key)
    assert got["_samples"].shape == (12, n, 6)
    _close_columns(got, want, _quantile_names())
    np.testing.assert_array_equal(got["n_missing"], want["n_missing"])


def test_reconstruction_and_seds_match_jax(fitters):
    """The same posterior draws through each package's simulator (exact
    routes on the CPU): reconstructed photometry and SED bands at 1e-4 of
    the row maximum."""
    rng = np.random.default_rng(8)
    samples = rng.uniform(LOW, HIGH, (6, 20, 6)).astype(np.float32)
    grid_kw = dict(n_ages=16, n_mets=4, n_wav=1024)
    filt = list(zip(CODES, CENTERS, WIDTHS))
    sim = tt.BatchSEDSimulator(
        tt.make_synthetic_grid(**grid_kw),
        tt.FilterSet([tt.tophat_filter(*f) for f in filt]), PNAMES,
        device="cpu")
    jsim = jst.BatchSEDSimulator(
        jst.make_synthetic_grid(**grid_kw),
        jst.FilterSet([jst.tophat_filter(*f) for f in filt]), PNAMES,
        photometry_backend="xla")
    names = list(PNAMES)[::-1]  # the fitter's columns in another order
    shuffled = samples[..., ::-1]
    got = tcat.reconstruct_photometry(sim, shuffled, names, max_draws=16,
                                      chunk=32)
    ref = jcat.reconstruct_photometry(jsim, shuffled, names, max_draws=16,
                                      chunk=32)
    assert got.shape == (6, 16, 5)
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(got - ref) <= 1e-4 * scale).all()
    seds = tcat.recover_seds_batched(sim, shuffled, names, max_draws=8,
                                     rows_per_call=20)
    jseds = jcat.recover_seds_batched(jsim, shuffled, names, max_draws=8,
                                      rows_per_call=20)
    np.testing.assert_allclose(seds["lam"], jseds["lam"], rtol=1e-12)
    q, jq = seds["fnu_quantiles"], jseds["fnu_quantiles"]
    assert q.shape == (6, 3, 1024)
    assert (np.abs(q - jq) <= 1e-4 * np.abs(jq).max(axis=-1,
                                                      keepdims=True)).all()
    with pytest.raises(ValueError, match="not among fitter parameters"):
        tcat.reconstruct_photometry(sim, samples[..., :5], names[:5])


def test_fit_catalogue_table_roundtrip(fitters, photometry, tmp_path):
    import pandas as pd

    port, _ = fitters
    lib, _, _, _ = photometry
    flux = lib[:20].copy()
    flux[3, 2] = -99.0
    cols = {f"f_{c}": flux[:, i] for i, c in enumerate(CODES)}
    cols.update({f"e_{c}": 0.05 * np.abs(flux[:, i]) + 0.1
                 for i, c in enumerate(CODES)})
    cols["ID"] = np.arange(100, 120)
    path = str(tmp_path / "fit.csv")
    handler = tcat.MissingPhotometryHandler(lib, k_neighbors=8, nmc=2,
                                            device="cpu")
    table, out = tt.fit_catalogue_table(
        port, cols, [f"f_{c}" for c in CODES], [f"e_{c}" for c in CODES],
        missing_data_flag=-99.0, save_path=path, n_samples=8,
        check_ood=False, missing_data_handler=handler,
        generator=torch.Generator().manual_seed(0))
    assert list(out["n_missing"]) == [0, 0, 0, 1] + [0] * 16
    back = pd.read_csv(path)
    assert list(back["ID"]) == list(range(100, 120))
    for name in _quantile_names():
        np.testing.assert_allclose(back[name], table[name], rtol=1e-6)
    slim, _ = tt.fit_catalogue_table(
        port, pd.DataFrame(cols), [f"f_{c}" for c in CODES],
        [f"e_{c}" for c in CODES], append_to_input=False, n_samples=8,
        check_ood=False)
    assert "f_F090W" not in slim and list(slim["ID"]) == list(range(100, 120))
    with pytest.raises(ValueError, match="one flux and one err column"):
        tt.fit_catalogue_table(port, cols, ["f_F090W"], ["e_F090W"])
    with pytest.raises(ValueError, match="needs `simulator`"):
        tt.fit_catalogue(port, flux[:2], flux[:2], recover_seds=True,
                         check_ood=False, n_samples=4)
