"""Port parity, the NLE and NRE engines: `posterior.LikelihoodPosterior` and
`RatioPosterior`, the general path of `evaluate_posterior`, the MCMC columns
of `fit_catalogue`, and `SBIFitter` with engine "nle"/"nre" (training, saved
files both ways), against the JAX package.

Toy problem of `tests/test_engines.py`: x = Aθ + ε, θ ~ U([-2, 2]²), σ 0.1.
Small sizes: hidden 16, 2 transforms, 2 members, ≤ 2 epochs.

Tolerances (absolute, float32): the posteriors' `log_prob` (the `_loglike`
term plus the prior) 1e-4 for flow likelihoods, 1e-5 for ratios, from JAX
weights, stacked (the mixture logsumexp − log K) and one member; a short
MCMC run of each posterior on JAX's replayed draws 1e-4; a saved model read
by the other package 1e-4 (NLE) and 1e-5 (NRE) on `log_prob`.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu_torch as tt
from synference_tpu.fitter import SBIFitter as JFitter
from synference_tpu.flows import build_flow as jbuild_flow
from synference_tpu.posterior import LikelihoodPosterior as JLike
from synference_tpu.posterior import RatioPosterior as JRatio
from synference_tpu.priors import BoxUniform as JBox
from synference_tpu.ratio import build_ratio_estimator as jbuild_ratio
from synference_tpu.train import TrainConfig as JTrainConfig
from synference_tpu_torch.flows.base import params_from_numpy

A = np.array([[1.0, 0.4], [-0.3, 1.0], [0.5, 0.5]], np.float32)
SIGMA = 0.1
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(n, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    x = theta @ A.T + SIGMA * rng.standard_normal((n, 3)).astype(np.float32)
    return theta, x


def _priors():
    return (JBox([-2.0, -2.0], [2.0, 2.0], ("a", "b")),
            tt.BoxUniform([-2.0, -2.0], [2.0, 2.0], ("a", "b"), device="cpu"))


def _perturbed(tree, seed, scale=0.1):
    leaves, treedef = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, tree))
    rng = np.random.default_rng(seed)
    leaves = [a + (scale * rng.standard_normal(a.shape)).astype(np.float32)
              for a in leaves]
    out = jax.tree_util.tree_unflatten(treedef, leaves)
    for k in ("theta_std", "x_std"):
        out[k] = np.abs(out[k]) + 0.5
    return out


def _estimators(kind, theta, x):
    """JAX estimator, port estimator and two perturbed JAX members."""
    if kind == "nle":
        jest = jbuild_flow("maf", 3, 2, hidden_features=16, num_transforms=2)
        est = tt.build_flow("maf", 3, 2, device="cpu", hidden_features=16,
                            num_transforms=2)
        trees = [_perturbed(jest.init(jax.random.PRNGKey(k), x, theta), k)
                 for k in (0, 1)]
    else:
        jest = jbuild_ratio(2, 3, hidden_features=16)
        est = tt.build_ratio_estimator(2, 3, hidden_features=16, device="cpu")
        trees = [jax.tree_util.tree_map(
            np.asarray, jest.init(jax.random.PRNGKey(k), theta, x))
            for k in (0, 1)]
    return jest, est, trees


def _posteriors(kind, jest, est, params_j, params_t, **kw):
    jprior, prior = _priors()
    if kind == "nle":
        n = 1 if params_j["theta_mean"].ndim == 1 else 2
        return (JLike(jest, params_j, jprior, n_members=n, **kw),
                tt.LikelihoodPosterior(est, params_t, prior, **kw))
    n = 1 if params_j["theta_mean"].ndim == 1 else 2
    return (JRatio(jest, params_j, jprior, n_members=n, **kw),
            tt.RatioPosterior(est, params_t, prior, **kw))


@pytest.mark.parametrize("kind", ["nle", "nre"])
@pytest.mark.parametrize("stacked", [False, True])
def test_posterior_log_prob(kind, stacked):
    """log_prob = _loglike + log prior (−inf outside the box), from JAX
    weights: 1e-4 (flow likelihood) or 1e-5 (ratio)."""
    theta, x = _toy(64, seed=1)
    theta[:3] = [[2.5, 0.0], [0.0, -2.1], [-3.0, 3.0]]  # outside the box
    jest, est, trees = _estimators(kind, theta, x)
    tree = (jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)
            if stacked else trees[0])
    jpost, post = _posteriors(kind, jest, est,
                              jax.tree_util.tree_map(jnp.asarray, tree),
                              params_from_numpy(tree, "cpu"))
    ref = np.asarray(jpost.log_prob(theta, x))
    with torch.no_grad():
        got = post.log_prob(theta, x).numpy()
    assert np.isneginf(got[:3]).all() and np.isneginf(ref[:3]).all()
    tol = 1e-4 if kind == "nle" else 1e-5
    np.testing.assert_allclose(got[3:], ref[3:], rtol=0, atol=tol)
    assert post.n_members == (2 if stacked else 1)


@pytest.mark.parametrize("kind", ["nle", "nre"])
def test_posterior_sample_batch_replays_jax(kind):
    """A short chain of the ensemble posterior (8 walkers, burn-in 4, thin
    1) on JAX's replayed draws: the same samples to 1e-4; acceptance and
    diagnostics are recorded."""
    from test_torch_mcmc import _jax_draws

    theta, x = _toy(64, seed=2)
    jest, est, trees = _estimators(kind, theta, x)
    tree = jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)
    kw = dict(n_walkers=8, burn_in=4, thin=1)
    jpost, post = _posteriors(kind, jest, est,
                              jax.tree_util.tree_map(jnp.asarray, tree),
                              params_from_numpy(tree, "cpu"), **kw)
    xs, n = x[:3], 16
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jpost.sample_batch(key, xs, n))
    draws = _jax_draws(key, jpost.prior, 3, 8, 4 + 2)
    with torch.no_grad():
        got = post.sample_batch(xs, n, draws=draws).numpy()
    assert got.shape == ref.shape == (3, n, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert post.last_acceptance == pytest.approx(jpost.last_acceptance,
                                                 abs=1e-6)
    assert post.last_diagnostics["rhat"].shape == (3, 2)
    single = post.sample(xs[0], 8, torch.Generator().manual_seed(0))
    assert single.shape == (8, 2)


def test_unconverged_chains_warn_and_flag_the_catalogue(caplog):
    """A short-chain posterior records R̂ > rhat_warn, logs a warning, and
    `fit_catalogue` flags every object (the JAX test's toy)."""
    from synference_tpu_torch.posterior import _MCMCPosterior

    class ToyPosterior(_MCMCPosterior):
        def _loglike(self, theta, x):
            return -0.5 * (((theta - x) / 0.01) ** 2).sum(dim=-1)

    prior = tt.BoxUniform([-5.0], [5.0], device="cpu")
    post = ToyPosterior(prior, n_walkers=16, burn_in=2, thin=1)
    with caplog.at_level("WARNING", logger="synference_tpu_torch.mcmc"):
        s = post.sample_batch([[1.0], [-2.0]], 64,
                              torch.Generator().manual_seed(0))
    assert s.shape == (2, 64, 1)
    assert np.nanmax(post.last_diagnostics["rhat"]) > post.rhat_warn
    assert "split-R-hat" in caplog.text

    class ToyFitter:
        parameter_names = ["a"]
        features = None
        posterior = post
        device = torch.device("cpu")

        def features_from_observations(self, flux, err, unit,
                                       missing_mask=None):
            return np.asarray(flux, np.float32)

    out = tt.fit_catalogue(ToyFitter(), np.array([[1.0], [-2.0]]),
                           np.array([[0.1], [0.1]]), check_ood=False,
                           n_samples=64)
    assert out["flag_mcmc_unconverged"].all()
    assert (out["mcmc_rhat_max"] > 1.1).all()
    assert "mcmc_ess_min" in out and "sampling_acceptance" not in out
    assert out["a_q50"].shape == (2,)


def _port_fitter(theta, x):
    fitter = tt.SBIFitter(np.abs(x) + 1.0, theta, ("a", "b"),
                          ("F1", "F2", "F3"), device="cpu")
    fitter.features, fitter.feature_params = x, theta
    fitter.feature_source = np.arange(len(x))
    fitter.create_priors()
    return fitter


def _jax_fitter(theta, x):
    fitter = JFitter(photometry=np.abs(x) + 1.0, parameters=theta,
                     parameter_names=("a", "b"),
                     filter_codes=("F1", "F2", "F3"))
    fitter.features, fitter.feature_params = x, theta
    fitter.feature_source = np.arange(len(x))
    fitter.feature_flags = None
    fitter.create_priors()
    return fitter


ENGINES = [("nle", "maf", dict(hidden_features=16, num_transforms=2)),
           ("nre", "mlp", dict(hidden_features=16, num_layers=2))]


@pytest.mark.parametrize("engine,model,kw", ENGINES)
def test_port_fitter_engine_saved_for_jax(engine, model, kw, tmp_path):
    """The port trains the engine (2 members, 2 epochs), samples and
    evaluates it; its saved file loads in the JAX package with the same
    log_prob, and back in the port bitwise."""
    theta, x = _toy(1200)
    fitter = _port_fitter(theta, x)
    fitter.run_single_sbi(model, engine=engine, n_nets=2,
                          train_config=tt.TrainConfig(max_epochs=2,
                                                      batch_size=128), **kw)
    assert fitter.engine == engine and fitter.posterior.n_members == 2
    s = fitter.sample_posterior(x[:4], 32)
    assert s.shape == (4, 32, 2) and np.isfinite(s).all()
    report = fitter.evaluate_model(n_samples=32, max_objects=8)
    assert "sampling_acceptance_min" not in report
    assert np.isfinite(report["tarp_deviation"])
    with pytest.raises(ValueError, match="npe ensemble"):
        fitter.evaluate_members()
    path = str(tmp_path / f"{engine}.pkl")
    fitter.save_state(path)
    jfit = JFitter.load_saved_model(path)
    assert jfit.engine == engine
    ref = np.asarray(jfit.posterior.log_prob(theta[:64], x[:64]))
    with torch.no_grad():
        got = fitter.posterior.log_prob(theta[:64], x[:64]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 if engine == "nle" else 1e-5)
    again = tt.SBIFitter.load_saved_model(path, device="cpu")
    with torch.no_grad():
        assert torch.equal(again.posterior.log_prob(theta[:64], x[:64]),
                           fitter.posterior.log_prob(theta[:64], x[:64]))


@pytest.mark.parametrize("engine,model,kw", ENGINES[:1] + [
    ("nre", "mdn", dict(hidden_features=16))])
def test_jax_saved_engine_loads_in_port(engine, model, kw, tmp_path):
    """A file the JAX package wrote (one member) loads in the port, whose
    posterior gives JAX's log_prob and samples under JAX's draws."""
    from test_torch_mcmc import _jax_draws

    theta, x = _toy(1200, seed=3)
    jfit = _jax_fitter(theta, x)
    jfit.run_single_sbi(model_type=model, engine=engine,
                        train_config=JTrainConfig(max_epochs=2,
                                                  batch_size=256), **kw)
    path = str(tmp_path / "jax.pkl")
    jfit.save_state(path)
    fitter = tt.SBIFitter.load_saved_model(path, device="cpu")
    assert fitter.engine == engine
    assert isinstance(fitter.posterior, tt.LikelihoodPosterior if engine ==
                      "nle" else tt.RatioPosterior)
    ref = np.asarray(jfit.posterior.log_prob(theta[:64], x[:64]))
    with torch.no_grad():
        got = fitter.posterior.log_prob(theta[:64], x[:64]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 if engine == "nle" else 1e-5)
    with open(path, "rb") as f:
        assert pickle.load(f)["n_members"] == 1
    jfit.posterior.burn_in = fitter.posterior.burn_in = 4
    jfit.posterior.n_walkers = fitter.posterior.n_walkers = 8
    key = jax.random.PRNGKey(1)
    ref_s = np.asarray(jfit.posterior.sample_batch(key, x[:2], 8))
    draws = _jax_draws(key, jfit.posterior.prior, 2, 8, 4 + 2)
    with torch.no_grad():
        got_s = fitter.posterior.sample_batch(x[:2], 8, draws=draws).numpy()
    np.testing.assert_allclose(got_s, ref_s, rtol=0, atol=1e-4)
