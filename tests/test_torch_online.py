"""The port's online engines (`online.py`, `SBIFitter.run_online_sbi`):
SNPE (TSNPE with its truncated-prior proposal), SNLE and SNRE on the toy
problem of `tests/test_engines.py` (x = Aθ + ε, θ ~ U([-2, 2]²)).

The port draws from a `torch.Generator`, so its rounds are not the JAX
package's draw for draw; each test holds the port to what the JAX tests of
the same engines hold theirs to (a history entry per round with the number
of finite simulations and the best validation loss, the per-round data,
later proposals concentrating on the observation) at hidden 16, ≤ 3
epochs, 400-600 simulations per round, and checks the saved online model in
both packages: a file the port wrote gives the JAX package the same
log-prob (1e-4 absolute and 1e-6 relative: far from the data the values
reach −10³, where one float32 ulp is 6e-5) and the port the same bits.
"""

import numpy as np
import pytest
import torch

import synference_tpu_torch as tt
from synference_tpu.fitter import SBIFitter as JFitter
from synference_tpu_torch import online

A = np.array([[1.0, 0.4], [-0.3, 1.0], [0.5, 0.5]], np.float32)
SIGMA = 0.1
THETA_TRUE = np.array([0.7, -0.9], np.float32)
X_OBS = THETA_TRUE @ A.T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _simulate(theta):
    """θ (B, 2) tensor -> noisy x (B, 3), seeded by the batch size."""
    g = torch.Generator().manual_seed(int(theta.shape[0]))
    eps = torch.randn((theta.shape[0], 3), generator=g)
    return theta @ torch.as_tensor(A.T) + SIGMA * eps


def _prior():
    return tt.BoxUniform([-2.0, -2.0], [2.0, 2.0], ("a", "b"), device="cpu")


CFG = tt.TrainConfig(max_epochs=3, batch_size=16, learning_rate=3e-3)


def test_truncated_prior_sample_stays_in_the_hpr():
    """TSNPE's proposal: uniform prior draws above the posterior's ε
    log-prob quantile, and the prior fallback when none pass."""
    prior = _prior()
    flow = tt.build_flow("nsf", 2, 3, device="cpu", hidden_features=8,
                         num_transforms=2)
    g = torch.Generator().manual_seed(0)
    theta = prior.sample(g, 600)
    res = tt.train_npe(flow, theta, _simulate(theta), g, CFG)
    post = tt.DirectPosterior(flow, res.params, prior)
    x_obs = prior._tensor(X_OBS)
    draws = online._truncated_prior_sample(g, prior, post, x_obs, 300)
    assert draws.shape == (300, 2)
    assert bool(prior.support_mask(draws).all())
    assert float(draws.std(dim=0).max()) < float(theta.std(dim=0).max())

    class Nowhere:  # a posterior whose HPR no prior draw reaches
        def sample(self, x, n, generator):
            return torch.zeros((n, 2))

        def log_prob(self, theta, x):
            return torch.where((theta == 0).all(-1), 0.0, -1.0)

    pad = online._truncated_prior_sample(g, prior, Nowhere(), x_obs, 50,
                                         max_tries=2)
    assert pad.shape == (50, 2) and bool(prior.support_mask(pad).all())


@pytest.mark.parametrize("engine,model,kw", [
    ("snpe", "nsf", dict(hidden_features=16, num_transforms=2)),
    ("snle", "maf", dict(hidden_features=16, num_transforms=2)),
    ("snre", "mlp", dict(hidden_features=16)),
])
def test_online_rounds(engine, model, kw):
    """Two rounds of each engine through `run_online_sbi`: one history
    entry per round, the rounds' data as numpy, round 2's proposals
    narrower than round 1's prior draws, and the posterior's draws for x_obs
    inside the box."""
    fitter = tt.SBIFitter(np.ones((8, 3)), np.zeros((8, 2)), ("a", "b"),
                          ("F1", "F2", "F3"), device="cpu")
    fitter.prior = _prior()
    post, data, hist = fitter.run_online_sbi(
        _simulate, X_OBS, engine=engine, model_type=model, n_rounds=2,
        sims_per_round=400, train_config=CFG,
        generator=torch.Generator().manual_seed(1), verbose=False, **kw)
    assert [h["round"] for h in hist] == [0, 1]
    assert [h["n_sims"] for h in hist] == [400, 800]
    assert all(np.isfinite(h["best_val"]) for h in hist)
    assert [d.shape for d in data["theta"]] == [(400, 2)] * 2
    assert [d.shape for d in data["x"]] == [(400, 3)] * 2
    assert data["theta"][1].std(0).max() < data["theta"][0].std(0).max()
    assert fitter.engine == engine[1:]
    s = post.sample(X_OBS, 64, torch.Generator().manual_seed(2))
    assert s.shape == (64, 2) and bool(fitter.prior.support_mask(s).all())


def test_online_model_saved_for_both_packages(tmp_path):
    """One SNLE round, saved: the JAX package reads the port's file with the
    same log-prob (1e-4 + 1e-6 relative); the port reloads it bitwise."""
    fitter = tt.SBIFitter(np.ones((8, 3)), np.zeros((8, 2)), ("a", "b"),
                          ("F1", "F2", "F3"), device="cpu")
    fitter.prior = _prior()
    post, _, _ = fitter.run_online_sbi(
        _simulate, X_OBS, engine="snle", model_type="maf", n_rounds=1,
        sims_per_round=600, train_config=CFG,
        generator=torch.Generator().manual_seed(0), verbose=False,
        hidden_features=12, num_transforms=2)
    assert fitter.engine == "nle" and fitter.train_result is None
    path = str(tmp_path / "online.pkl")
    fitter.save_state(path)
    theta = _prior().sample(torch.Generator().manual_seed(5), 32)
    x = np.tile(X_OBS, (32, 1))
    with torch.no_grad():
        lp = post.log_prob(theta, x)
    jfit = JFitter.load_saved_model(path)
    assert jfit.engine == "nle"
    np.testing.assert_allclose(
        np.asarray(jfit.posterior.log_prob(theta.numpy(), x)), lp.numpy(),
        rtol=1e-6, atol=1e-4)
    again = tt.SBIFitter.load_saved_model(path, device="cpu")
    with torch.no_grad():
        assert torch.equal(again.posterior.log_prob(theta, x), lp)
    with pytest.raises(ValueError, match="unknown online engine"):
        fitter.run_online_sbi(_simulate, X_OBS, engine="abc")
