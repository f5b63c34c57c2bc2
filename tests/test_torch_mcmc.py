"""Port parity, `mcmc.py`: `split_rhat_ess` and `run_batched_mcmc` against
the JAX package, and the diagnostic tests of `tests/test_mcmc_recovery.py`
on the port.

- `split_rhat_ess` on seeded chains, to 1e-5 relative, and the NaN of a
  chain shorter than 4 steps.
- `run_batched_mcmc` on a Gaussian target, replaying JAX's key splits (the
  initial walkers, and per half-step the stretch uniforms, the partner
  indices and the accept uniforms) over a short chain: the kept states and
  R̂/ESS to 1e-5, the acceptance exactly (the same accept decisions).
- A long chain of the port alone (32 walkers, 2200 steps) recovers each
  object's Gaussian (means within 0.05, standard deviations within 10%) and
  reports R̂ < 1.1, ESS > 100; a short chain on a needle reports R̂ > 1.1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synference_tpu import mcmc as jmcmc
from synference_tpu.priors import BoxUniform as JBox
from synference_tpu_torch import mcmc as tmcmc
from synference_tpu_torch.priors import BoxUniform

KEY = jax.random.PRNGKey(0)
XS = np.array([[1.0, -0.5], [-1.0, 2.0], [0.3, 0.1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jtarget(theta, x):
    return -0.5 * jnp.sum(((theta - x) / 0.3) ** 2, axis=-1)


def _ttarget(theta, x):
    return -0.5 * (((theta - x) / 0.3) ** 2).sum(dim=-1)


def _jax_draws(key, prior, m, n_walkers, n_steps):
    """The draws `run_batched_mcmc` of the JAX package takes from `key`."""
    half = n_walkers // 2
    k_init, k_run = jax.random.split(key)
    walkers = np.asarray(prior.sample(k_init, m * n_walkers)).reshape(
        m, n_walkers, prior.dim)
    shape = (n_steps, 2, m, half)
    stretch, accept = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    partner = np.zeros(shape, np.int32)
    for s, k in enumerate(jax.random.split(k_run, n_steps)):
        for j, kk in enumerate(jax.random.split(k)):
            k1, k2, k3 = jax.random.split(kk, 3)
            stretch[s, j] = jax.random.uniform(k1, (m, half))
            partner[s, j] = jax.random.randint(k2, (m, half), 0, half)
            accept[s, j] = jax.random.uniform(k3, (m, half))
    return {"walkers": walkers, "stretch": stretch, "partner": partner,
            "accept": accept}


@pytest.mark.parametrize("shape", [(40, 3, 8, 2), (17, 2, 6, 3), (4, 1, 4, 1)])
def test_split_rhat_ess_matches_jax(shape):
    """Seeded AR(1)-correlated chains: R̂ and ESS to 1e-5 relative."""
    rng = np.random.default_rng(sum(shape))
    noise = rng.standard_normal(shape).astype(np.float32)
    chain = np.empty_like(noise)
    chain[0] = noise[0]
    for t in range(1, shape[0]):
        chain[t] = 0.7 * chain[t - 1] + noise[t]
    chain += rng.normal(0, 0.3, shape[1:]).astype(np.float32)  # walker offsets
    jr, je = jmcmc.split_rhat_ess(chain)
    tr, te = tmcmc.split_rhat_ess(torch.as_tensor(chain))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5)


def test_tiny_chain_returns_nan():
    rhat, ess = tmcmc.split_rhat_ess(torch.zeros((3, 3, 8, 2)))
    assert rhat.shape == (3, 2) and ess.shape == (3, 2)
    assert torch.isnan(rhat).all() and torch.isnan(ess).all()
    jr, _ = jmcmc.split_rhat_ess(np.zeros((3, 3, 8, 2), np.float32))
    assert np.isnan(np.asarray(jr)).all()


@pytest.mark.parametrize("n_walkers,n_steps,burn_in,thin",
                         [(8, 12, 4, 2), (6, 10, 0, 1)])
def test_batched_mcmc_replays_jax(n_walkers, n_steps, burn_in, thin):
    """The same draws give the same chain: kept states, R̂ and ESS to 1e-5,
    the acceptance exactly."""
    jprior = JBox([-5.0, -5.0], [5.0, 5.0])
    prior = BoxUniform([-5.0, -5.0], [5.0, 5.0], device="cpu")
    key = jax.random.PRNGKey(3)
    ref, ref_acc, ref_diag = jmcmc.run_batched_mcmc(
        _jtarget, jprior, XS, key=key, n_walkers=n_walkers, n_steps=n_steps,
        burn_in=burn_in, thin=thin, return_diagnostics=True)
    draws = _jax_draws(key, jprior, len(XS), n_walkers, n_steps)
    got, acc, diag = tmcmc.run_batched_mcmc(
        _ttarget, prior, XS, n_walkers=n_walkers, n_steps=n_steps,
        burn_in=burn_in, thin=thin, return_diagnostics=True, draws=draws)
    assert got.shape == tuple(np.shape(ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert float(acc) == pytest.approx(float(ref_acc), abs=1e-6)
    for k in ("rhat", "ess"):
        np.testing.assert_allclose(diag[k].numpy(), np.asarray(ref_diag[k]),
                                   rtol=1e-5)


def test_init_theta_is_clipped_and_checked():
    prior = BoxUniform([0.0], [1.0], device="cpu")
    init = np.full((1, 4, 1), 2.0, np.float32)
    s, _ = tmcmc.run_batched_mcmc(lambda t, x: torch.zeros(t.shape[0]), prior,
                                  [[0.0]], torch.Generator().manual_seed(0),
                                  n_walkers=4, n_steps=1, burn_in=0,
                                  init_theta=init)
    assert float(s.max()) <= 1.0
    with pytest.raises(ValueError, match="init_theta must be"):
        tmcmc.run_batched_mcmc(lambda t, x: torch.zeros(t.shape[0]), prior,
                               [[0.0]], n_walkers=4, n_steps=1,
                               init_theta=init[:, :2])


def test_long_chain_converges():
    prior = BoxUniform([-5.0, -5.0], [5.0, 5.0], device="cpu")
    kept, acc, diag = tmcmc.run_batched_mcmc(
        _ttarget, prior, XS[:2], torch.Generator().manual_seed(1),
        n_walkers=32, n_steps=2200, burn_in=600, thin=2,
        return_diagnostics=True)
    kept = kept.numpy()
    assert kept.shape == (2, 800 * 32, 2)
    np.testing.assert_allclose(kept.mean(axis=1), XS[:2], atol=0.05)
    np.testing.assert_allclose(kept.std(axis=1), 0.3, rtol=0.1)
    assert 0.2 < float(acc) < 0.9
    assert (diag["rhat"].numpy() < 1.1).all()
    assert (diag["ess"].numpy() > 100).all()


def test_short_chain_flags_nonconvergence():
    """A short chain on a needle-in-a-box target reports a high R̂."""
    prior = BoxUniform([-5.0, -5.0], [5.0, 5.0], device="cpu")

    def needle(theta, x):
        return -0.5 * (((theta - x) / 0.01) ** 2).sum(dim=-1)

    _, _, diag = tmcmc.run_batched_mcmc(
        needle, prior, XS[:1], torch.Generator().manual_seed(0), n_walkers=32,
        n_steps=20, burn_in=4, thin=1, return_diagnostics=True)
    assert float(np.nanmax(diag["rhat"].numpy())) > 1.1
