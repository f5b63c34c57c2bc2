"""Port parity, the rest of `diagnostics.py` and `priors.py`, and the
fitter's validation methods: C2ST, L-C2ST, the marginal misspecification
check, permutation and Shapley feature importance, `RestrictedPrior`, the
NPE-vs-HMC cross-check and the six `SBIFitter` methods.

Posteriors are `DirectPosterior`s of an NSF (16 hidden, 3 transforms, 4
bins) from the JAX package's weights (`params_from_numpy`), last layers
perturbed as in `tests/test_torch_posterior.py`.

Tolerances:
- `feature_importance` and `shapley_feature_importance` from the same
  weights and the same numpy permutations (the Shapley seed drawn from the
  JAX key as the JAX package draws it): 1e-5 absolute.
- `misspecification_check` from the same marginal-flow weights:
  log-densities and the threshold to 1e-5 relative, the same flags.
- `lc2st` from JAX's replayed draws (θ̂, the x_obs draws, the swap masks
  and the initial w1; 4 null classifiers, 30 epochs of full-batch Adam):
  statistics to 1e-4 relative (measured 1.6e-5), the main classifier's
  probabilities within 1e-5 (measured 2.1e-6), the same p-value. Longer
  training drifts apart as ReLU kinks flip on float32 rounding: one null
  statistic 7e-3 relative after 60 epochs, 6.6e-2 after 200.
- `c2st` and `RestrictedPrior` train the port's own classifier
  (`classifier.py`, sklearn's defaults) where the JAX package trains
  sklearn's, so they are held by value: C2ST accuracy within ±0.05 of the
  JAX package's on the cases of `tests/test_mcmc_recovery.py` (same and
  shifted normals, 800 each), and the restricted prior's validity agreeing
  with sklearn's on ≥ 97% of a 60×60 θ grid.
- The stratified folds equal sklearn's `StratifiedKFold` exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu import diagnostics as jd
from synference_tpu import posterior as jpost
from synference_tpu import priors as jpriors
from synference_tpu.flows import base as jbase
from synference_tpu_torch import diagnostics as td
from synference_tpu_torch import priors as tpriors
from synference_tpu_torch.flows import base as tbase
from synference_tpu_torch.posterior import DirectPosterior

CFG = dict(hidden_features=16, num_transforms=3, num_bins=4)
DIM, CTX = 2, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: these loops run thousands of small
    ops, and beside the other test workers the default thread pool turns a
    1-s C2ST into minutes (measured: 1.2 s against 156 s on 8 loaded
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _posteriors():
    """(JAX posterior, port posterior) of one NSF member, same weights."""
    jflow = jbase.build_flow("nsf", DIM, CTX, **CFG)
    flow = tbase.build_flow("nsf", DIM, CTX, device="cpu", **CFG)
    rng = np.random.default_rng(0)
    theta = rng.uniform(-1.5, 1.5, (200, DIM)).astype(np.float32)
    x = rng.standard_normal((200, CTX)).astype(np.float32)
    p = jax.tree_util.tree_map(np.asarray,
                               jflow.init(jax.random.PRNGKey(0), theta, x))
    for block in p["flow"]["blocks"]:
        block[-1]["w"] = (0.1 * rng.standard_normal(block[-1]["w"].shape)
                          ).astype(np.float32)
    low, high = [-2.0, -2.0], [2.0, 2.0]
    return (jpost.DirectPosterior(jflow, p, jpriors.BoxUniform(low, high)),
            DirectPosterior(flow, tbase.params_from_numpy(p, "cpu"),
                            tpriors.BoxUniform(low, high, device="cpu")))


def _xs_truths(n=48, seed=1):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, CTX)).astype(np.float32)
    truths = np.clip(0.5 * xs[:, :DIM] + 0.3 * rng.standard_normal(
        (n, DIM)), -1.9, 1.9).astype(np.float32)
    return xs, truths


# -- feature attribution -------------------------------------------------------
def test_feature_importance_matches_jax():
    jpo, tpo = _posteriors()
    xs, truths = _xs_truths()
    ref = jd.feature_importance(jpo, xs, truths)
    got = td.feature_importance(tpo, xs, truths)
    assert got.shape == (CTX,)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_shapley_matches_jax_and_is_efficient():
    jpo, tpo = _posteriors()
    xs, truths = _xs_truths()
    key = jax.random.PRNGKey(4)
    ref = jd.shapley_feature_importance(jpo, xs, truths, key=key,
                                        n_permutations=4)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    got = td.shapley_feature_importance(tpo, xs, truths, seed=seed,
                                        n_permutations=4)
    np.testing.assert_allclose(got["shapley"], ref["shapley"], atol=1e-5)
    for k in ("total_gain", "base_log_prob", "masked_log_prob"):
        assert got[k] == pytest.approx(ref[k], abs=1e-5)
    assert got["total_gain"] == pytest.approx(
        got["base_log_prob"] - got["masked_log_prob"], rel=1e-4)


# -- marginal misspecification -------------------------------------------------
def test_misspecification_check_matches_jax_weights():
    rng = np.random.default_rng(2)
    x_train = rng.standard_normal((400, 3)).astype(np.float32)
    x_obs = np.concatenate([rng.standard_normal((6, 3)),
                            8.0 + rng.standard_normal((6, 3))]
                           ).astype(np.float32)
    jflow = jbase.build_flow("maf", 3, 0, hidden_features=16,
                             num_transforms=2)
    flow = tbase.build_flow("maf", 3, 0, hidden_features=16,
                            num_transforms=2, device="cpu")
    p = jax.tree_util.tree_map(np.asarray, jflow.init(
        jax.random.PRNGKey(1), x_train, np.zeros((400, 0), np.float32)))
    ref = jd.misspecification_check(jflow, p, x_train, x_obs)
    got = td.misspecification_check(flow, tbase.params_from_numpy(p, "cpu"),
                                    x_train, x_obs)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)
    assert got[2] == pytest.approx(ref[2], rel=1e-5)
    assert got[0][6:].all()


def test_marginal_flow_flags_shifted_observations(rng):
    """`fit_marginal_flow` trains through `train_ensemble` (port alone;
    the JAX test is marked slow): 8σ-shifted rows are all flagged."""
    x_train = rng.standard_normal((2000, 4)).astype(np.float32)
    flow, params = td.fit_marginal_flow(
        x_train, torch.Generator().manual_seed(0), hidden_features=16,
        num_transforms=2, max_epochs=6, device="cpu")
    x_ok = rng.standard_normal((20, 4)).astype(np.float32)
    x_bad = 8.0 + rng.standard_normal((20, 4)).astype(np.float32)
    assert td.misspecification_check(flow, params, x_train, x_ok)[0].mean() < 0.3
    assert td.misspecification_check(flow, params, x_train, x_bad)[0].all()


# -- L-C2ST --------------------------------------------------------------------
def _lc2st_draws(key, jpo, theta_cal, x_cal, x_obs, n_null, n_obs, hidden):
    """The draws `diagnostics.lc2st` of the JAX package takes from `key`."""
    k_post, k_obs, k_perm, k_init = jax.random.split(key, 4)
    n = theta_cal.shape[0]
    d_in = theta_cal.shape[1] + x_cal.shape[1]
    w1 = []
    for k in jax.random.split(k_init, n_null + 1):
        k1, _ = jax.random.split(k)
        w1.append(np.sqrt(2.0 / d_in) * np.asarray(
            jax.random.normal(k1, (hidden, d_in))))
    return {"theta_hat": np.asarray(jpo.sample_batch(
                k_post, jnp.asarray(x_cal), 1))[:, 0],
            "obs_samples": np.asarray(jpo.sample(k_obs, x_obs, n_obs)),
            "masks": np.asarray(jax.random.bernoulli(k_perm, 0.5,
                                                     (n_null, n, 1))),
            "w1": np.stack(w1).astype(np.float32)}


def test_lc2st_replays_jax():
    jpo, tpo = _posteriors()
    x_cal, theta_cal = _xs_truths(n=160, seed=3)
    x_obs = x_cal[0]
    kw = dict(n_null=4, n_obs_samples=200, hidden=16, n_epochs=30)
    key = jax.random.PRNGKey(5)
    ref = jd.lc2st(jpo, theta_cal, x_cal, x_obs, key=key, **kw)
    draws = _lc2st_draws(key, jpo, theta_cal, x_cal, x_obs, 4, 200, 16)
    got = td.lc2st(tpo, theta_cal, x_cal, x_obs, draws=draws, **kw)
    assert got["stat"] == pytest.approx(ref["stat"], rel=1e-4)
    np.testing.assert_allclose(got["null_stats"], ref["null_stats"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["probs_obs"], ref["probs_obs"], atol=1e-5)
    assert got["p_value"] == ref["p_value"]
    assert got["reject"] == ref["reject"]


# -- C2ST and the restricted prior (held by value) -----------------------------
def test_stratified_folds_equal_sklearn():
    from sklearn.model_selection import StratifiedKFold

    for n0, n1 in ((800, 800), (7, 11), (512, 256)):
        labels = np.concatenate([np.zeros(n0), np.ones(n1)])
        folds = td._stratified_test_folds(labels, 3)
        for f, (_, test) in enumerate(StratifiedKFold(3).split(
                np.zeros(len(labels)), labels)):
            np.testing.assert_array_equal(np.flatnonzero(folds == f), test)


@pytest.mark.parametrize("shift", [0.0, 2.0])
def test_c2st_by_value_against_sklearn(rng, shift):
    x = rng.standard_normal((800, 4))
    y = shift + rng.standard_normal((800, 4))
    ref = jd.c2st(x, y)
    got = td.c2st(x, y, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    assert abs(got - ref) < 0.05, (got, ref)
    if shift:
        assert got > 0.8
    else:
        assert abs(got - 0.5) < 0.07


def test_restricted_prior_by_value_against_sklearn(rng):
    theta = rng.uniform(-1, 1, (3000, 2)).astype(np.float32)
    x = np.ones((3000, 3), np.float32)
    x[theta[:, 0] > 0.5] = np.nan
    ref = jpriors.restricted_prior_from_simulations(
        jpriors.BoxUniform([-1.0, -1.0], [1.0, 1.0], ("a", "b")), theta, x)
    base = tpriors.BoxUniform([-1.0, -1.0], [1.0, 1.0], ("a", "b"),
                              device="cpu")
    rp = tt.restricted_prior_from_simulations(
        base, theta, x, generator=torch.Generator().manual_seed(0))
    g = np.linspace(-1, 1, 60, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    agree = (rp.support_mask(grid).numpy()
             == np.asarray(ref.support_mask(grid))).mean()
    assert agree >= 0.97, agree
    s = rp.sample(torch.Generator().manual_seed(0), 500)
    assert s.shape == (500, 2) and (s[:, 0] < 0.6).float().mean() > 0.95
    lp = rp.log_prob(np.array([[0.9, 0.0], [0.0, 0.0]])).numpy()
    assert lp[0] == -np.inf and np.isfinite(lp[1])
    assert rp.names == ("a", "b") and rp.dim == 2


def test_restricted_prior_degenerate_labels(rng):
    base = tpriors.BoxUniform([0.0], [1.0], device="cpu")
    theta = rng.random((100, 1)).astype(np.float32)
    rp = tt.restricted_prior_from_simulations(base, theta,
                                              np.ones((100, 2), np.float32))
    assert rp.sample(torch.Generator().manual_seed(0), 50).shape == (50, 1)
    dead = tt.restricted_prior_from_simulations(
        base, theta, np.full((100, 2), np.nan, np.float32))
    assert not dead.support_mask(theta).any()
    with pytest.raises(RuntimeError, match="acceptance"):
        dead.sample(torch.Generator().manual_seed(0), 5, max_tries=3)


# -- the cross-check -----------------------------------------------------------
def test_posterior_crosscheck_runs_flow_against_hmc():
    """An untrained flow over (log10_mass, tau_v) against HMC through the
    simulator, 2 objects: one C2ST per object in [0, 1], both sample sets
    of the requested size inside the box, `_mega_off` restored."""
    grid = tt.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0)
    filt = tt.FilterSet([tt.tophat_filter("F115W", 11500.0, 2600.0),
                         tt.tophat_filter("F200W", 20000.0, 4600.0),
                         tt.tophat_filter("F356W", 35600.0, 7800.0)])
    sim = tt.BatchSEDSimulator(
        grid=grid, filters=filt, param_names=("log10_mass", "tau_v"),
        fixed_params={"redshift": 1.0, "peak_age": 3e8, "tau": 0.5,
                      "log10_metallicity": -2.5},
        emission=tt.EmissionConfig(igm="inoue14"), device="cpu")
    prior = tt.BoxUniform([8.0, 0.0], [11.0, 2.0], device="cpu")
    flow = tt.build_flow("nsf", 2, 3, hidden_features=8, num_transforms=2,
                         device="cpu", support_low=(8.0, 0.0),
                         support_high=(11.0, 2.0))
    gen = torch.Generator().manual_seed(0)
    x_obs = sim.photometry(torch.tensor([[9.4, 0.5], [10.0, 1.1]]))
    params = flow.init(gen, prior.sample(gen, 64),
                       torch.log10(x_obs).repeat(32, 1))
    post = DirectPosterior(flow, params, prior)
    out = td.posterior_crosscheck(post, sim, torch.log10(x_obs), x_obs,
                                  0.05 * x_obs, prior, gen, n_samples=64,
                                  n_chains=4, n_warmup=10)
    assert out["c2st"].shape == (2,)
    assert ((out["c2st"] >= 0) & (out["c2st"] <= 1)).all()
    assert out["flow_samples"].shape == out["hmc_samples"].shape == (2, 64, 2)
    assert 0.0 < out["hmc_acceptance"] <= 1.0
    assert bool(prior.support_mask(out["hmc_samples"]).all())
    assert sim._mega_off is False


# -- the fitter ------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _fitter():
    rng = np.random.default_rng(6)
    theta = rng.uniform(0, 1, (600, 2)).astype(np.float32)
    phot = (10.0 ** (1.0 + theta @ rng.uniform(0.5, 1.5, (2, 4)))
            ).astype(np.float32)
    f = tt.SBIFitter(phot, theta, ["a", "b"], ["f1", "f2", "f3", "f4"],
                     device="cpu")
    f.create_feature_array(tt.FeatureConfig(
        filter_codes=("f1", "f2", "f3", "f4"), include_errors=False))
    f.run_single_sbi("nsf", hidden_features=8, num_transforms=2,
                     train_config=tt.TrainConfig(max_epochs=2,
                                                 batch_size=128),
                     generator=torch.Generator().manual_seed(0))
    return f


def test_fitter_validation_methods(tmp_path):
    f = _fitter()
    assert f.training_log_probs.shape == f.validation_log_probs.shape
    np.testing.assert_array_equal(f.training_log_probs,
                                  -np.asarray(f.train_result.train_losses))
    x = f.features[f._split["test"][:5]]
    g = torch.Generator().manual_seed(3)
    one = f.calculate_map(x[0], generator=g, n_starts=64)
    many = f.calculate_map(x, generator=g, n_starts=64)
    assert one.shape == (2,) and many.shape == (5, 2)
    assert bool(f.prior.support_mask(many).all())
    res = f.lc2st(x[0], n_cal=50, generator=g, n_null=3, n_obs_samples=64,
                  n_epochs=10)
    assert 0.0 < res["p_value"] <= 1.0 and np.isfinite(res["stat"])
    flags, lp, thresh = f.detect_misspecification(
        np.concatenate([x, x + 50.0]), generator=g, max_train=400)
    assert flags.shape == (10,) and flags[5:].all() and np.isfinite(thresh)
    path = tmp_path / "metrics.json"
    f.save_metrics({"lc2st": res, "map": many, "n": np.int64(3)}, str(path))
    import json
    saved = json.loads(path.read_text())
    assert saved["n"] == 3 and len(saved["map"]) == 5
