"""Port parity, the rest of `mcmc.py` and the simulator-gradient
diagnostics: likelihoods, the ensemble sampler, HMC, MAP + Laplace, VI,
SMC and model comparison, the Fisher forecast and score compression,
against the JAX package on replayed draws (the JAX key splits' draws passed
as `draws=`), and the recovery checks of `tests/test_mcmc_recovery.py` at
tiny sizes.

Setup: `tests/conftest.py`'s 32×5×512 `test_grid` built by both packages,
three tophat bands, lognormal SFH, Calzetti, Inoue14, θ = (log10_mass,
tau_v) with the rest fixed, as the JAX tests do; ≤ 4 objects, ≤ 8 HMC
steps of ≤ 3 leapfrog, ≤ 50 MAP/VI steps.

Tolerances:
- likelihoods and the Dirichlet transform: 1e-6 relative, log_ndtr 40σ
  into the censored tail included; the censored gradient of both packages
  within 1e-4 of its row's largest entry of a float64 derivative
  (measured 3.3e-5, JAX 2.4e-5).
- the ensemble sampler on replayed draws: samples and log-probabilities
  to 1e-5, the same acceptance.
- HMC on replayed draws (2 objects × 2 chains, 4 + 4 warmup and 4 sampling
  steps of 3 leapfrog): samples within 1e-4 of the prior width, the
  log-posteriors to 1e-3 relative (measured 4.5e-4: a 1e-4 width moves
  χ² at 5% errors by ~1e-2), the mean acceptance probability within 1e-3
  (measured 1.2e-4; it averages exp(min(ΔH, 0)), not the decisions).
- MAP on a shared candidate set (30 Adam steps): θ_map within 1e-4 of the
  prior width, the Laplace σ to 1e-3 relative, −log posterior and the
  log-likelihood within 1e-3 absolute; censored bands too.
- VI on replayed normals (30 steps): mean and σ within 1e-4 of the prior
  width, ELBO within 1e-3 absolute.
- SMC on replayed draws and the same host seed: the same stages, log Z
  within 1e-4, samples within 1e-5; against the analytic evidence of a
  box-truncated Gaussian within 0.15 (the JAX test's bound).
- Fisher matrices and score-compression weights: 1e-4 relative to each
  matrix's largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu import mcmc as jm
from synference_tpu_torch import mcmc as tm

KEY = jax.random.PRNGKey(0)
LOW, HIGH = [8.0, 0.0], [11.0, 2.0]
WIDTH = np.array(HIGH) - np.array(LOW)


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


def _model(pkg):
    grid = pkg.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0)
    filt = pkg.FilterSet([pkg.tophat_filter("F115W", 11500.0, 2600.0),
                          pkg.tophat_filter("F200W", 20000.0, 4600.0),
                          pkg.tophat_filter("F356W", 35600.0, 7800.0)])
    kw = dict(device="cpu") if pkg is tt else {}
    return pkg.BatchSEDSimulator(
        grid=grid, filters=filt, param_names=("log10_mass", "tau_v"),
        fixed_params={"redshift": 1.0, "peak_age": 3e8, "tau": 0.5,
                      "log10_metallicity": -2.5},
        sfh="lognormal", zdist="delta",
        emission=pkg.EmissionConfig(igm="inoue14"), **kw)


@functools.lru_cache(maxsize=None)
def _sims():
    return _model(jst), _model(tt)


def _priors():
    return (jst.BoxUniform(LOW, HIGH),
            tt.BoxUniform(LOW, HIGH, device="cpu"))


@functools.lru_cache(maxsize=None)
def _catalogue(n=2, seed=0):
    jsim, _ = _sims()
    rng = np.random.default_rng(seed)
    truths = np.stack([rng.uniform(8.5, 10.5, n), rng.uniform(0.1, 1.5, n)],
                      1).astype(np.float32)
    x = np.asarray(jsim.photometry(jnp.asarray(truths)))
    return truths, x, 0.05 * x


# -- likelihoods -------------------------------------------------------------
@pytest.mark.parametrize("censored", [False, True])
def test_censored_loglike_and_gradient_match_jax(censored):
    rng = np.random.default_rng(1)
    model = rng.normal(0, 30, (16, 5)).astype(np.float32)
    x = rng.normal(0, 1, (16, 5)).astype(np.float32)
    sig = rng.uniform(0.5, 2, (16, 5)).astype(np.float32)
    lim = (rng.uniform(size=(16, 5)) < 0.4) if censored else None
    ref = np.asarray(jm.censored_gaussian_loglike_rows(
        jnp.asarray(model), x, sig, None if lim is None else jnp.asarray(lim)))
    g_ref = np.asarray(jax.grad(lambda mm: jm.censored_gaussian_loglike_rows(
        mm, x, sig, None if lim is None else jnp.asarray(lim)).sum())(
            jnp.asarray(model)))
    tmod = torch.as_tensor(model).requires_grad_(True)
    got = tm.censored_gaussian_loglike_rows(
        tmod, torch.as_tensor(x), torch.as_tensor(sig),
        None if lim is None else torch.as_tensor(lim))
    (g,) = torch.autograd.grad(got.sum(), tmod)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6)
    assert np.isfinite(g.numpy()).all()
    if lim is None:
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-6, atol=1e-6)
        return
    # log Φ's derivative 40σ deep: both packages against float64
    from scipy.special import log_ndtr
    from scipy.stats import norm
    z = -(model.astype(np.float64) - x) / sig
    exact = np.where(lim, -np.exp(norm.logpdf(z) - log_ndtr(z)), z) / sig
    scale = np.abs(exact).max(axis=1, keepdims=True)
    assert (np.abs(g.numpy() - exact) < 1e-4 * scale).all()
    assert (np.abs(g_ref - exact) < 1e-4 * scale).all()


def test_gaussian_loglike():
    ll = tm.gaussian_loglike(lambda th: th * 2.0, np.array([2.0]),
                             np.array([0.1]), device="cpu")
    v = ll(torch.tensor([[1.0], [0.0]])).numpy()
    assert v[0] == pytest.approx(0.0) and v[1] == pytest.approx(-200.0)


def test_dirichlet_transform_matches_jax(rng):
    u = rng.random((100, 3)).astype(np.float32)
    fr = tm.dirichlet_cumsum_transform(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(
        fr, np.asarray(jm.dirichlet_cumsum_transform(jnp.asarray(u))),
        rtol=1e-6, atol=1e-7)
    assert fr.shape == (100, 4) and (fr >= 0).all()
    np.testing.assert_allclose(fr.sum(1), 1.0, atol=1e-5)


# -- ensemble MCMC -------------------------------------------------------------
def _ensemble_draws(key, prior, n_walkers, n_steps):
    """The draws `run_ensemble_mcmc` of the JAX package takes from `key`."""
    half = n_walkers // 2
    k_init, k_run = jax.random.split(key)
    shape = (n_steps, 2, half)
    out = {"walkers": np.asarray(prior.sample(k_init, n_walkers)),
           "stretch": np.zeros(shape, np.float32),
           "partner": np.zeros(shape, np.int32),
           "accept": np.zeros(shape, np.float32)}
    for s, k in enumerate(jax.random.split(k_run, n_steps)):
        for j, kk in enumerate(jax.random.split(k)):
            k1, k2, k3 = jax.random.split(kk, 3)
            out["stretch"][s, j] = jax.random.uniform(k1, (half,))
            out["partner"][s, j] = jax.random.randint(k2, (half,), 0, half)
            out["accept"][s, j] = jax.random.uniform(k3, (half,))
    return out


def test_ensemble_mcmc_replays_jax():
    mu, sd = np.array([1.0, -0.5]), np.array([0.3, 0.6])
    jp = jst.BoxUniform([-5.0, -5.0], [5.0, 5.0])
    tp = tt.BoxUniform([-5.0, -5.0], [5.0, 5.0], device="cpu")
    kw = dict(n_walkers=16, n_steps=40, burn_in=10)
    ref_s, ref_lp, ref_acc = jm.run_ensemble_mcmc(
        lambda t: -0.5 * jnp.sum(((t - mu) / sd) ** 2, axis=-1), jp, KEY, **kw)
    s, lp, acc = tm.run_ensemble_mcmc(
        lambda t: -0.5 * (((t - torch.as_tensor(mu, dtype=torch.float32))
                           / torch.as_tensor(sd, dtype=torch.float32)) ** 2
                          ).sum(-1), tp,
        draws=_ensemble_draws(KEY, jp, 16, 40), **kw)
    np.testing.assert_allclose(s.numpy(), ref_s, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=1e-5, atol=1e-5)
    assert float(acc) == pytest.approx(ref_acc, abs=1e-6)


def test_ensemble_mcmc_recovers_gaussian_and_box():
    mu, sd = torch.tensor([1.0, -0.5]), torch.tensor([0.3, 0.6])
    prior = tt.BoxUniform([-5.0, -5.0], [5.0, 5.0], device="cpu")
    s, _, acc = tm.run_ensemble_mcmc(
        lambda t: -0.5 * (((t - mu) / sd) ** 2).sum(-1), prior,
        torch.Generator().manual_seed(0), n_walkers=64, n_steps=800,
        burn_in=300)
    assert 0.1 < float(acc) < 0.9
    np.testing.assert_allclose(s.mean(0).numpy(), mu.numpy(), atol=0.08)
    np.testing.assert_allclose(s.std(0).numpy(), sd.numpy(), atol=0.1)
    flat = tt.BoxUniform([0.0], [1.0], device="cpu")
    s, _, _ = tm.run_ensemble_mcmc(lambda t: torch.zeros(t.shape[0]), flat,
                                   torch.Generator().manual_seed(1),
                                   n_walkers=32, n_steps=300, burn_in=100)
    assert ((s >= 0) & (s <= 1)).all() and abs(float(s.mean()) - 0.5) < 0.06


def test_fit_observation_mcmc_through_the_simulator():
    _, tsim = _sims()
    truths, x, sigma = _catalogue()
    _, tp = _priors()
    s, _, _ = tm.fit_observation_mcmc(
        tsim, x[0], sigma[0], tp, torch.Generator().manual_seed(0),
        n_walkers=32, n_steps=200, burn_in=100)
    med = s.median(dim=0).values.numpy()
    assert abs(med[0] - truths[0, 0]) < 0.3 and abs(med[1] - truths[0, 1]) < 0.5


# -- HMC -----------------------------------------------------------------------
def _hmc_draws(key, prior, m, c, n_warmup, n_samples):
    """The draws `fit_catalogue_hmc` of the JAX package takes from `key`:
    split(key, 3) -> candidates, warmup, run; warmup split in two phases;
    per step split(k) -> momenta, accept uniforms."""
    k_init, k_warm, k_run = jax.random.split(key, 3)
    n_wa = max(n_warmup // 2, 1)
    n_wb = max(n_warmup - n_wa, 1)
    k_wa, k_wb = jax.random.split(k_warm)
    keys = (list(jax.random.split(k_wa, n_wa))
            + list(jax.random.split(k_wb, n_wb))
            + list(jax.random.split(k_run, n_samples)))
    mom, acc = [], []
    for k in keys:
        k1, k2 = jax.random.split(k)
        mom.append(np.asarray(jax.random.normal(k1, (m * c, prior.dim))))
        acc.append(np.asarray(jax.random.uniform(k2, (m * c,))))
    return {"candidates": np.asarray(prior.sample(k_init, max(256, 8 * c))),
            "momenta": np.stack(mom), "accept": np.stack(acc)}


@pytest.mark.parametrize("censored", [False, True])
def test_hmc_replays_jax(censored):
    jsim, tsim = _sims()
    jp, tp = _priors()
    _, x, sigma = _catalogue()
    lim = None
    if censored:
        lim = np.zeros_like(x, bool)
        lim[:, -1] = True
    kw = dict(n_chains=2, n_warmup=8, n_samples=4, n_leapfrog=3)
    ref_s, ref_lp, ref_acc = jm.fit_catalogue_hmc(
        jsim, x, sigma, jp, key=KEY, upper_limits=lim, **kw)
    s, lp, acc = tm.fit_catalogue_hmc(
        tsim, x, sigma, tp, upper_limits=lim,
        draws=_hmc_draws(KEY, jp, 2, 2, 8, 4), **kw)
    assert s.shape == ref_s.shape == (2, 8, 2)
    assert (np.abs(s.numpy() - ref_s) <= 1e-4 * WIDTH).all(), \
        np.abs(s.numpy() - ref_s).max(axis=(0, 1))
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=1e-3)
    assert float(acc) == pytest.approx(ref_acc, abs=1e-3)
    assert tsim._mega_off is False


def test_hmc_init_theta_ranks_candidates_as_jax():
    jsim, tsim = _sims()
    jp, tp = _priors()
    truths, x, sigma = _catalogue()
    init = np.asarray(jp.sample(jax.random.PRNGKey(7), 2 * 6)).reshape(2, 6, 2)
    kw = dict(n_chains=2, n_warmup=2, n_samples=2, n_leapfrog=2)
    ref_s, _, _ = jm.fit_catalogue_hmc(jsim, x, sigma, jp, key=KEY,
                                       init_theta=init, **kw)
    draws = _hmc_draws(KEY, jp, 2, 2, 2, 2)
    s, _, _ = tm.fit_catalogue_hmc(tsim, x, sigma, tp, init_theta=init,
                                   draws=draws, **kw)
    assert (np.abs(s.numpy() - ref_s) <= 1e-4 * WIDTH).all()
    with pytest.raises(ValueError, match="init_theta"):
        tm.fit_catalogue_hmc(tsim, x, sigma, tp, init_theta=init[:, :1],
                             draws=draws, **kw)


def test_hmc_recovers_truth_through_simulator():
    """Port alone, the JAX test's setting cut to 2 objects × 4 chains,
    60 warmup + 80 samples of 6 leapfrog: medians on the truths within
    4 posterior widths, widths far inside the prior's."""
    _, tsim = _sims()
    _, tp = _priors()
    truths, x, sigma = _catalogue()
    s, lp, acc = tm.fit_catalogue_hmc(
        tsim, x, sigma, tp, torch.Generator().manual_seed(3), n_chains=4,
        n_warmup=60, n_samples=80, n_leapfrog=6)
    s = s.numpy()
    assert s.shape == (2, 320, 2) and np.isfinite(s).all()
    assert torch.isfinite(lp).all() and 0.3 < float(acc) <= 1.0
    med, std = np.median(s, axis=1), s.std(axis=1)
    assert (np.abs(med - truths) < np.maximum(4 * std, [0.05, 0.08])).all()
    assert (std[:, 0] < 0.1).all() and (std[:, 1] < 0.3).all()


def test_fit_observation_hmc_wraps_the_catalogue():
    _, tsim = _sims()
    jp, tp = _priors()
    _, x, sigma = _catalogue()
    draws = _hmc_draws(KEY, jp, 1, 2, 2, 3)
    kw = dict(n_chains=2, n_warmup=2, n_samples=3, n_leapfrog=2)
    one = tm.fit_observation_hmc(tsim, x[0], sigma[0], tp, draws=draws, **kw)
    cat = tm.fit_catalogue_hmc(tsim, x[:1], sigma[0], tp, draws=draws, **kw)
    assert torch.equal(one[0], cat[0][0]) and torch.equal(one[1], cat[1][0])


# -- MAP and VI ----------------------------------------------------------------
@pytest.mark.parametrize("censored", [False, True])
def test_map_matches_jax_on_shared_candidates(censored):
    jsim, tsim = _sims()
    jp, tp = _priors()
    _, x, sigma = _catalogue()
    lim = None
    if censored:
        x = x.copy()
        x[:, -1] *= 2.0
        lim = np.zeros_like(x, bool)
        lim[:, -1] = True
    kw = dict(n_steps=30, n_restarts=2, upper_limits=lim)
    ref = jm.fit_catalogue_map(jsim, x, sigma, jp, key=KEY, **kw)
    cand = np.asarray(jp.sample(KEY, 64))
    out = tm.fit_catalogue_map(tsim, x, sigma, tp,
                               draws={"candidates": cand}, **kw)
    assert (np.abs(out["theta_map"].numpy() - ref["theta_map"])
            <= 1e-4 * WIDTH).all()
    np.testing.assert_allclose(out["laplace_sigma"].numpy(),
                               ref["laplace_sigma"], rtol=1e-3)
    np.testing.assert_allclose(out["neg_logpost"].numpy(),
                               ref["neg_logpost"], atol=1e-3)
    np.testing.assert_allclose(out["log_like"].numpy(), ref["log_like"],
                               atol=1e-3)
    assert tsim._mega_off is False


def test_map_recovers_truths_at_fisher_scale():
    _, tsim = _sims()
    _, tp = _priors()
    truths, x, sigma = _catalogue(4, seed=2)
    out = tm.fit_catalogue_map(tsim, x, sigma, tp,
                               torch.Generator().manual_seed(2), n_steps=50)
    tm_ = out["theta_map"].numpy()
    assert np.abs(tm_[:, 0] - truths[:, 0]).max() < 0.1
    assert np.abs(tm_[:, 1] - truths[:, 1]).max() < 0.2
    fr = tt.fisher_forecast(tsim, truths, sigma)
    ratio = (out["laplace_sigma"] / fr["cramer_rao_sigma"]).numpy()
    assert 0.5 < np.nanmedian(ratio) < 2.0


def _vi_draws(key, prior, m, n_steps, n_mc):
    k_init, k_run = jax.random.split(key)
    eps = np.stack([np.asarray(jax.random.normal(k, (m, n_mc, prior.dim)))
                    for k in jax.random.split(k_run, n_steps)])
    return {"candidates": np.asarray(prior.sample(k_init, 256)), "eps": eps,
            "eps_samples": np.asarray(jax.random.normal(
                jax.random.fold_in(k_run, 1), (m, 256, prior.dim)))}


def test_vi_replays_jax():
    jsim, tsim = _sims()
    jp, tp = _priors()
    _, x, sigma = _catalogue()
    kw = dict(n_steps=30, n_mc=4)
    ref = jm.fit_catalogue_vi(jsim, x, sigma, jp, key=KEY, **kw)
    out = tm.fit_catalogue_vi(tsim, x, sigma, tp,
                              draws=_vi_draws(KEY, jp, 2, 30, 4), **kw)
    for k in ("mean", "sigma"):
        assert (np.abs(out[k].numpy() - ref[k]) <= 1e-4 * WIDTH).all(), k
    np.testing.assert_allclose(out["elbo"].numpy(), ref["elbo"], atol=1e-3)
    assert out["samples"].shape == (2, 256, 2)


def test_fitters_restore_mega_off_after_a_failure():
    """`_mega_off` is restored in `finally`, also when the photometry
    raises (the JAX package restores it only on success)."""
    _, tp = _priors()

    class Failing:
        _mega_off = False
        calls = 0

        def photometry(self, theta):
            assert self._mega_off
            self.calls += 1
            if self.calls > 1:
                raise RuntimeError("boom")
            return torch.ones((theta.shape[0], 3))

    for fit in (tm.fit_catalogue_map, tm.fit_catalogue_vi,
                tm.fit_catalogue_hmc):
        sim = Failing()
        with pytest.raises(RuntimeError, match="boom"):
            fit(sim, np.ones((1, 3)), np.ones(3), tp,
                torch.Generator().manual_seed(0))
        assert sim._mega_off is False


# -- SMC -----------------------------------------------------------------------
def _smc_setup(pkg, x0=(0.3, 0.3), a=2.0, sigma=0.2):
    kw = dict(device="cpu") if pkg is tt else {}
    prior = pkg.BoxUniform([-a] * 2, [a] * 2, **kw)
    x0 = np.asarray(x0, np.float32)
    const = 2 * 0.5 * np.log(2 * np.pi * sigma ** 2)
    if pkg is tt:
        def loglike(theta):
            return (-0.5 * (((theta - torch.as_tensor(x0)) / sigma) ** 2
                            ).sum(-1) - const)
    else:
        def loglike(theta):
            return -0.5 * jnp.sum(((theta - x0) / sigma) ** 2, -1) - const
    from scipy.stats import norm
    log_z = sum(np.log((norm.cdf((a - x) / sigma) - norm.cdf((-a - x) / sigma))
                       / (2 * a)) for x in x0)
    return prior, loglike, log_z


def _smc_draws(key, prior, n, n_moves, max_stages):
    """`run_smc`'s draws of the JAX package: split(key) -> particles and
    the stage chain; the host seed from the chain's key; per stage
    split(k_loop) -> next, moves; per half-sweep split(k, 3)."""
    half = n // 2
    k_init, k_loop = jax.random.split(key)
    seed = int(jax.random.randint(k_loop, (), 0, 2**31 - 1))
    shape = (max_stages, 2 * n_moves, half)
    out = {"particles": np.asarray(prior.sample(k_init, n)),
           "stretch": np.zeros(shape, np.float32),
           "partner": np.zeros(shape, np.int32),
           "accept": np.zeros(shape, np.float32)}
    for stage in range(max_stages):
        k_loop, k_m = jax.random.split(k_loop)
        for h, k in enumerate(jax.random.split(k_m, 2 * n_moves)):
            k1, k2, k3 = jax.random.split(k, 3)
            out["stretch"][stage, h] = jax.random.uniform(k1, (half,))
            out["partner"][stage, h] = jax.random.randint(k2, (half,), 0,
                                                          half)
            out["accept"][stage, h] = jax.random.uniform(k3, (half,))
    return out, seed


def test_smc_replays_jax():
    jp, jll, _ = _smc_setup(jst)
    tp, tll, _ = _smc_setup(tt)
    kw = dict(n_particles=256, n_moves=2, max_stages=12)
    ref_s, ref_z, ref_info = jm.run_smc(jll, jp, key=KEY, **kw)
    draws, seed = _smc_draws(KEY, jp, 256, 2, 12)
    s, z, info = tm.run_smc(tll, tp, seed=seed, draws=draws, **kw)
    assert info["n_stages"] == ref_info["n_stages"]
    np.testing.assert_allclose(info["betas"], ref_info["betas"], rtol=1e-5)
    assert z == pytest.approx(ref_z, abs=1e-4)
    np.testing.assert_allclose(s.numpy(), ref_s, atol=1e-5)


def test_smc_evidence_matches_analytic():
    prior, loglike, log_z_true = _smc_setup(tt)
    s, log_z, info = tm.run_smc(loglike, prior,
                                torch.Generator().manual_seed(0),
                                n_particles=2048, n_moves=4)
    assert abs(log_z - log_z_true) < 0.15, (log_z, log_z_true)
    assert info["betas"][-1] == pytest.approx(1.0)
    assert np.abs(s.mean(0).numpy() - 0.3).max() < 0.05
    assert np.abs(s.std(0).numpy() - 0.2).max() < 0.05
    _, bad, _ = _smc_setup(tt, x0=(1.9, -1.9))
    _, z_bad, _ = tm.run_smc(bad, prior, torch.Generator().manual_seed(1),
                             n_particles=1024)
    assert log_z > z_bad


def test_model_comparison_through_the_simulator():
    _, tsim = _sims()
    _, tp = _priors()
    truths, x, sigma = _catalogue(1)
    const = tt.BatchSEDSimulator(
        tsim.grid, tsim.filters, ("log10_mass", "tau_v"), sfh="constant",
        fixed_params={"redshift": 1.0, "log10_metallicity": -2.5},
        emission=tt.EmissionConfig(igm="inoue14"), device="cpu")
    out = tm.model_comparison({"lognormal": tsim, "const": const}, x[0],
                              sigma[0], {"lognormal": tp, "const": tp},
                              torch.Generator().manual_seed(0),
                              n_particles=128, n_moves=2)
    assert np.isfinite(out["lognormal"]["log_z"])
    assert np.isfinite(out["const"]["log_z"])
    assert out["log_bayes_factors"][out["best_model"]] == 0.0
    assert out["lognormal"]["log_z"] - out["const"]["log_z"] > -5.0


# -- Fisher and score compression ----------------------------------------------
def _rel_to_max(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    return (np.abs(np.asarray(got) - ref).reshape(ref.shape[0], -1).max(
        axis=1) / scale).max()


def test_fisher_forecast_matches_jax():
    jsim, tsim = _sims()
    truths, _, sigma = _catalogue(4, seed=5)
    ref = jst.fisher_forecast(jsim, truths, sigma)
    out = tt.fisher_forecast(tsim, truths, sigma)
    assert _rel_to_max(out["fisher"].numpy(), ref["fisher"]) < 1e-4
    np.testing.assert_allclose(out["cramer_rao_sigma"].numpy(),
                               ref["cramer_rao_sigma"], rtol=1e-4)
    assert out["param_names"] == ("log10_mass", "tau_v")
    assert tsim._mega_off is False


def test_score_compression_matches_jax_and_recovers_shifts():
    jsim, tsim = _sims()
    theta_fid = np.array([9.3, 0.6], np.float32)
    x_fid = np.asarray(jsim.photometry(jnp.asarray(theta_fid[None])))[0]
    ref = jst.score_compression(jsim, theta_fid, 0.05 * x_fid)
    sc = tt.score_compression(tsim, theta_fid, 0.05 * x_fid)
    assert _rel_to_max(sc["weights"].numpy()[None], ref["weights"][None]) < 1e-4
    assert _rel_to_max(sc["fisher"].numpy()[None], ref["fisher"][None]) < 1e-4
    t0 = sc["compress"](torch.as_tensor(x_fid[None]))[0].numpy()
    np.testing.assert_allclose(t0, theta_fid, rtol=1e-4, atol=1e-4)
    for delta in ([0.05, 0.0], [0.0, 0.05], [0.03, -0.04]):
        th = theta_fid + np.asarray(delta, np.float32)
        x = tsim.photometry(torch.as_tensor(th[None]))
        np.testing.assert_allclose(sc["compress"](x)[0].numpy(), th,
                                   atol=0.01)
