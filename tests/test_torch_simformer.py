"""The port's simformer (`synference_tpu_torch/simformer.py`) against the
JAX package's at tiny widths (d_model ≤ 16, ≤ 2 layers).

Tolerances: the score, the ε-prediction and the loss from the same weights
(JAX's, through `load_params`) and the same draws (condition masks, t and ε
from the JAX keys) within 1e-5 relative; the loss's gradient within 1e-4
relative in norm; `log_prob` by the probability-flow ODE at 20 steps within
1e-4 absolute. Samples are held by distribution: the port draws all
objects' rows from one generator in one batch where the JAX package splits
one key per object, so no draw is shared. Saved models load in both
packages."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synference_tpu import simformer as js
from synference_tpu_torch import simformer as ts

CFG = dict(n_tokens=5, d_model=16, n_heads=2, n_layers=2, d_ff=32,
           t_embed_dim=8)
N_THETA = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX model and parameters (a small random output layer, so that
    the score is not zero) and the port's model holding the same
    weights."""
    jm = js.Simformer(js.SimformerConfig(**CFG))
    params = jm.init(jax.random.PRNGKey(1))
    params["out"]["w"] = 0.3 * jax.random.normal(jax.random.PRNGKey(9),
                                                 params["out"]["w"].shape)
    params["out"]["b"] = jnp.full((1,), 0.1)
    tm = ts.Simformer(ts.SimformerConfig(**CFG), device="cpu")
    tm.load_params(jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _std():
    rng = np.random.default_rng(4)
    return {"mu": rng.standard_normal(5).astype(np.float32),
            "sd": rng.uniform(0.5, 2.0, 5).astype(np.float32),
            "n_theta": N_THETA, "n_x": 3}


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


class TestVPSDE:
    def test_boundary_values(self):
        sde = ts.VPSDE()
        assert float(sde.alpha(0.0)) == pytest.approx(1.0)
        assert float(sde.sigma(1.0)) == pytest.approx(1.0, abs=1e-3)
        assert float(sde.sigma(1e-4)) < 0.01

    def test_variance_preserved(self):
        sde = ts.VPSDE()
        for t in [0.1, 0.5, 0.9]:
            a, s = float(sde.alpha(t)), float(sde.sigma(t))
            assert a**2 + s**2 == pytest.approx(1.0, abs=1e-4)

    def test_matches_jax(self):
        t = np.linspace(0.0, 1.0, 33, dtype=np.float32)
        jsde, tsde = js.VPSDE(), ts.VPSDE()
        for name in ("alpha", "sigma", "beta"):
            np.testing.assert_allclose(
                getattr(tsde, name)(torch.tensor(t)).numpy(),
                np.asarray(getattr(jsde, name)(jnp.asarray(t))), rtol=1e-6,
                atol=1e-7)


class TestScoreNet:
    def test_parameter_layout_is_the_jax_tree(self, models):
        jm, params, tm = models
        mine = jax.tree_util.tree_structure(
            ts.tree_map(lambda p: 0, tm.params()))
        theirs = jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda a: 0, params))
        assert mine == theirs
        assert tuple(tm.layers[0].qkv.w.shape) == (3 * 16, 16)  # (out, in)
        with pytest.raises(ValueError):
            tm.load_params({"out": params["out"]})

    def test_shapes(self):
        model = ts.Simformer(ts.SimformerConfig(n_tokens=10, d_model=16,
                                                n_heads=2, n_layers=2),
                             device="cpu")
        model.init(torch.Generator().manual_seed(0))
        s = model.score(torch.zeros(4, 10), torch.full((4,), 0.5),
                        torch.zeros(4, 10))
        assert s.shape == (4, 10) and torch.isfinite(s).all()

    def test_attn_mask_blocks(self):
        m = ts.block_attn_mask(3, 4, "causal")
        assert m.shape == (7, 7)
        assert m[0, :3].all() and not m[0, 3:].any()  # θ sees θ only
        assert m[3, :4].all() and not m[3, 4:].any()  # x0 sees θ + itself
        np.testing.assert_array_equal(m, js.block_attn_mask(3, 4, "causal"))

    def test_full_mask(self):
        assert ts.block_attn_mask(2, 2, "full").all()
        with pytest.raises(ValueError):
            ts.block_attn_mask(2, 2, "banded")

    def test_time_embedding_matches_jax(self):
        """The angles are bitwise the JAX package's (the same float32
        frequencies); sin and cos differ by at most an ulp of 1."""
        t = np.random.default_rng(0).uniform(1e-3, 1, 64).astype(np.float32)
        np.testing.assert_allclose(
            ts._time_embedding(torch.tensor(t), 8).numpy(),
            np.asarray(js._time_embedding(jnp.asarray(t), 8)), rtol=0,
            atol=1.2e-7)

    @pytest.mark.parametrize("mask", [None, "causal"])
    def test_score_and_eps_match_jax(self, models, mask):
        jm, params, tm = models
        rng = np.random.default_rng(0)
        v = rng.standard_normal((7, 5)).astype(np.float32)
        t = rng.uniform(1e-3, 1, 7).astype(np.float32)
        cond = (rng.uniform(size=(7, 5)) < 0.4).astype(np.float32)
        m = None if mask is None else js.block_attn_mask(2, 3, mask)
        jmask = None if m is None else jnp.asarray(m)
        tmask = None if m is None else torch.tensor(m)
        args = (torch.tensor(v), torch.tensor(t), torch.tensor(cond), tmask)
        with torch.no_grad():
            assert _rel(tm.score(*args), jm.score(params, v, t, cond,
                                                  jmask)) < 1e-5
            assert _rel(tm.eps_pred(*args), jm.eps_pred(params, v, t, cond,
                                                        jmask)) < 1e-5


def _jax_step_draws(key, vb):
    """The draws of one JAX training step (`train_simformer`'s loss_fn):
    condition masks, t and ε from the key's split."""
    k1, k2, k3 = jax.random.split(key, 3)
    b = vb.shape[0]
    cond = js._random_condition_masks(k1, b, N_THETA, 3)
    t = jax.random.uniform(k2, (b,), minval=1.0e-3, maxval=1.0)
    _, eps = js.VPSDE().marginal(k3, vb, t)
    return cond, t, eps


def _jax_loss(jm, p, cond, t, eps, vb):
    v_t = js.VPSDE().alpha(t)[:, None] * vb + js.VPSDE().sigma(t)[:, None] * eps
    v_t = jnp.where(cond == 1.0, vb, v_t)
    eps_hat = jm.eps_pred(p, v_t, t, cond)
    w = 1.0 - cond
    return jnp.sum(w * (eps_hat - eps) ** 2) / jnp.maximum(w.sum(), 1.0)


def test_loss_and_gradient_match_jax_on_its_draws(models):
    jm, params, tm = models
    vb = jnp.asarray(np.random.default_rng(1).standard_normal(
        (64, 5)).astype(np.float32))
    cond, t, eps = _jax_step_draws(jax.random.PRNGKey(3), vb)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jm, p, cond, t, eps, vb)))(params)
    draws = [torch.tensor(np.asarray(a)) for a in (cond, t, eps)]
    lt = ts.simformer_loss(tm, torch.tensor(np.asarray(vb)), *draws)
    assert abs(float(lt.detach()) - float(lj)) / abs(float(lj)) < 1e-5
    grads = torch.autograd.grad(lt, list(tm.parameters()))
    gt = dict(zip([n for n, _ in tm.named_parameters()], grads))
    flat_j, flat_t = [], []
    for path, g in jax.tree_util.tree_flatten_with_path(gj)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        flat_j.append(np.asarray(g).ravel())
        flat_t.append(gt[name].numpy().ravel())
    flat_j, flat_t = np.concatenate(flat_j), np.concatenate(flat_t)
    assert (np.linalg.norm(flat_t - flat_j)
            / np.linalg.norm(flat_j)) < 1e-4


def test_condition_masks_mix_the_three_tasks():
    g = torch.Generator().manual_seed(0)
    m = ts._random_condition_masks(g, 6000, 2, 3, "cpu")
    post = (m == torch.tensor([0.0, 0.0, 1.0, 1.0, 1.0])).all(1)
    joint = (m == 0).all(1)
    assert 0.3 < post.float().mean() < 0.37  # 1/3 + a Bernoulli share
    assert 0.33 < joint.float().mean() < 0.40
    rand_rows = m[~post & ~joint]
    assert 0.25 < rand_rows.mean() < 0.40


@pytest.mark.parametrize("mask", [None, [0.0, 1.0, 1.0, 0.0, 1.0]])
def test_log_prob_matches_jax(models, mask):
    """PF-ODE log p(θ | x) at 20 steps, default and a custom condition
    mask (θ1 and x2 latent), within 1e-4 absolute."""
    jm, params, tm = models
    rng = np.random.default_rng(2)
    theta = rng.standard_normal((6, 2)).astype(np.float32)
    xs = rng.standard_normal((6, 3)).astype(np.float32)
    jp = js.SimformerPosterior(jm, params, _std(), n_steps=20)
    tp = ts.SimformerPosterior(tm, None, _std(), n_steps=20)
    lj = np.asarray(jp.log_prob(theta, xs, condition_mask=(
        None if mask is None else jnp.asarray(mask))))
    lt = tp.log_prob(theta, xs, condition_mask=mask).numpy()
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="every token observed"):
        tp.log_prob(theta, xs, condition_mask=np.ones(5))


def test_samples_match_jax_by_distribution(models):
    """Reverse-SDE draws (30 steps) from the same weights: per-parameter
    means and standard deviations of 3000 draws agree within sampling
    error."""
    jm, params, tm = models
    x_obs = np.array([0.5, -0.2, 1.0], np.float32)
    jp = js.SimformerPosterior(jm, params, _std(), n_steps=30)
    tp = ts.SimformerPosterior(tm, None, _std(), n_steps=30)
    sj = np.asarray(jp.sample(jax.random.PRNGKey(5), x_obs, 3000))
    st = tp.sample(x_obs, 3000, torch.Generator().manual_seed(5)).numpy()
    assert st.shape == (3000, 2) and np.isfinite(st).all()
    se = sj.std(0) / np.sqrt(3000)
    assert (np.abs(st.mean(0) - sj.mean(0)) < 5 * np.sqrt(2) * se).all()
    assert (np.abs(st.std(0) / sj.std(0) - 1.0) < 0.08).all()
    batch = tp.sample_batch(np.stack([x_obs, -x_obs]), 16,
                            torch.Generator().manual_seed(0))
    assert batch.shape == (2, 16, 2)


def test_validation_draws_are_fixed_and_training_learns():
    """At learning rate 0 the weights stay put (AdamW's decay scales with
    the rate), so a validation loss that repeats exactly shows the same
    draws every epoch; at 3e-3 the loss falls."""
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((600, 2)).astype(np.float32)
    x = (theta @ rng.standard_normal((2, 3)) + 0.1 * rng.standard_normal(
        (600, 3))).astype(np.float32)
    model = ts.Simformer(ts.SimformerConfig(**CFG), device="cpu")
    _, std, hist = ts.train_simformer(model, theta, x, batch_size=128,
                                      learning_rate=0.0, max_epochs=3)
    assert hist["val"][0] == hist["val"][1] == hist["val"][2]
    np.testing.assert_allclose(std["sd"], np.concatenate(
        [theta, x], 1).std(0), rtol=1e-5)
    params, _, hist = ts.train_simformer(model, theta, x, batch_size=64,
                                         learning_rate=3e-3, max_epochs=3,
                                         stop_after_epochs=3)
    assert min(hist["val"][1:]) < hist["val"][0]
    assert np.isfinite(hist["train"]).all()
    # the model holds the best epoch's weights, which `params` copies
    best = params["layers"][0]["qkv"]["w"]
    assert torch.equal(best, model.layers[0].qkv.w.detach())
    assert best.data_ptr() != model.layers[0].qkv.w.data_ptr()


def test_recovers_a_conditional():
    """x = θ + 0.1 ε, θ ~ N(0, 1): after a short training the conditional
    mean tracks x and the spread sits well below the prior's; observing x0
    alone leaves θ1 near its prior width (the JAX test's checks, at 1200
    rows and 12 epochs)."""
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((1200, 2)).astype(np.float32)
    x = (theta + 0.1 * rng.standard_normal((1200, 2))).astype(np.float32)
    model = ts.Simformer(ts.SimformerConfig(n_tokens=4, d_model=16,
                                            n_heads=2, n_layers=2, d_ff=32),
                         device="cpu")
    params, std, hist = ts.train_simformer(
        model, theta, x, batch_size=64, learning_rate=3e-3, max_epochs=12,
        stop_after_epochs=12)
    assert hist["val"][-1] < hist["val"][0]
    post = ts.SimformerPosterior(model, params, std, n_steps=100)
    x_obs = np.array([1.0, -1.0], np.float32)
    s = post.sample(x_obs, 800, torch.Generator().manual_seed(3)).numpy()
    assert abs(s[:, 0].mean() - 1.0) < 0.35
    assert abs(s[:, 1].mean() + 1.0) < 0.35
    assert s.std(0).max() < 0.6
    s2 = post.sample(x_obs, 800, torch.Generator().manual_seed(4),
                     condition_mask=[0.0, 0.0, 1.0, 0.0]).numpy()
    assert s2[:, 1].std() > 0.6
    assert abs(s2[:, 0].mean() - 1.0) < 0.35


def test_noise_model_task_runs():
    rng = np.random.default_rng(0)
    mags = rng.uniform(22.0, 30.0, (300, 2)).astype(np.float32)
    log_errs = (0.3 * (mags - 26.0)).astype(np.float32)
    model, post = ts.train_noise_model_simformer(
        mags, log_errs, torch.Generator().manual_seed(0), device="cpu",
        batch_size=128, max_epochs=1)
    assert model.cfg.d_model == 64 and post.n_steps == 300
    post.n_steps = 10
    s = post.sample(np.array([23.0, 29.0], np.float32), 8)
    assert s.shape == (8, 2) and torch.isfinite(s).all()


class TestPersistence:
    def _posterior(self, models, mask=None):
        jm, params, tm = models
        return ts.SimformerPosterior(tm, None, _std(), attn_mask=mask,
                                     n_steps=20)

    def test_roundtrip_identical_samples(self, models, tmp_path):
        post = self._posterior(models)
        path = str(tmp_path / "simformer.pkl")
        post.save(path)
        loaded = ts.SimformerPosterior.load(path, device="cpu")
        x_obs = np.array([0.5, -0.2, 1.0], np.float32)
        s1 = post.sample(x_obs, 16, torch.Generator().manual_seed(0))
        s2 = loaded.sample(x_obs, 16, torch.Generator().manual_seed(0))
        assert torch.equal(s1, s2)
        assert loaded.n_steps == post.n_steps and loaded.attn_mask is None

    @pytest.mark.parametrize("mask", [None, "causal"])
    def test_models_load_both_ways(self, models, tmp_path, mask):
        """The port's saved model loads in the JAX package and the JAX
        package's in the port, with the same log-density."""
        m = None if mask is None else js.block_attn_mask(2, 3, mask)
        post = self._posterior(models, m)
        rng = np.random.default_rng(3)
        theta = rng.standard_normal((4, 2)).astype(np.float32)
        xs = rng.standard_normal((4, 3)).astype(np.float32)
        path = str(tmp_path / "port.pkl")
        post.save(path)
        jpost = js.SimformerPosterior.load(path)
        np.testing.assert_allclose(np.asarray(jpost.log_prob(theta, xs)),
                                   post.log_prob(theta, xs).numpy(),
                                   rtol=0, atol=1e-4)
        jpath = str(tmp_path / "jax.pkl")
        jpost.save(jpath)
        back = ts.SimformerPosterior.load(jpath, device="cpu")
        assert back.state_dict().keys() == post.state_dict().keys()
        assert torch.equal(back.log_prob(theta, xs), post.log_prob(theta,
                                                                   xs))


def _port_fitter():
    from synference_tpu_torch.fitter import SBIFitter

    rng = np.random.default_rng(1)
    theta = rng.standard_normal((400, 2)).astype(np.float32)
    x = theta @ rng.standard_normal((2, 3)).astype(np.float32)
    fitter = SBIFitter(photometry=np.abs(x) + 1.0, parameters=theta,
                       parameter_names=("a", "b"),
                       filter_codes=("F1", "F2", "F3"), device="cpu")
    fitter.features = x
    fitter.feature_params = theta
    fitter.feature_source = np.arange(len(x))
    fitter.create_priors()
    return fitter, theta, x


def test_fitter_saves_and_loads_both_ways(tmp_path):
    """`run_single_simformer` → `save_state` → `load_saved_model` in both
    packages: engine "simformer", the same samples from the same
    generator in the port, the same log-density in the JAX package."""
    from synference_tpu.fitter import SBIFitter as JaxFitter
    from synference_tpu_torch.fitter import SBIFitter

    fitter, theta, x = _port_fitter()
    hist = fitter.run_single_simformer(d_model=16, n_heads=2, n_layers=1,
                                       batch_size=128, max_epochs=2,
                                       n_diffusion_steps=20)
    assert len(hist["val"]) == 2 and fitter.engine == "simformer"
    path = str(tmp_path / "fitter_simformer.pkl")
    fitter.save_state(path)
    loaded = SBIFitter.load_saved_model(path, device="cpu")
    assert loaded.engine == "simformer"
    s1 = fitter.sample_posterior(x[:3], n_samples=8)
    s2 = loaded.sample_posterior(x[:3], n_samples=8)
    assert s1.shape == (3, 8, 2)
    np.testing.assert_array_equal(s1, s2)
    jloaded = JaxFitter.load_saved_model(path)
    assert jloaded.engine == "simformer"
    lp = fitter.posterior.log_prob(theta[:4], x[:4]).numpy()
    np.testing.assert_allclose(
        np.asarray(jloaded.posterior.log_prob(theta[:4], x[:4])), lp,
        rtol=0, atol=1e-4)
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert "flow_spec" not in state and state["simformer"]["kind"] == \
        "simformer"
    # the JAX package's own saved simformer fitter loads in the port
    jpath = str(tmp_path / "jax_fitter.pkl")
    jloaded.save_state(jpath)
    back = SBIFitter.load_saved_model(jpath, device="cpu")
    np.testing.assert_allclose(back.posterior.log_prob(theta[:4],
                                                       x[:4]).numpy(),
                               lp, rtol=0, atol=1e-6)
    report = back.posterior.log_prob(theta[:4], x[:4])
    assert torch.isfinite(report).all()


def test_evaluate_posterior_takes_a_simformer(models):
    from synference_tpu_torch.diagnostics import evaluate_posterior

    post = TestPersistence()._posterior(models)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((8, 3)).astype(np.float32)
    truths = rng.standard_normal((8, 2)).astype(np.float32)
    rep = evaluate_posterior(post, xs, truths, n_samples=32)
    assert np.isfinite(rep["mean_log_prob"])
    assert 0.0 <= rep["tarp_deviation"] <= 1.0
