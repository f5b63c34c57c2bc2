"""Port parity, priors and posteriors: `priors.py` and `posterior.py`
against the JAX package.

`BoxUniform` and `priors_from_library` are exact. `DirectPosterior` and
`EnsemblePosterior` get the JAX package's weights through
`params_from_numpy`, and the base normals that the JAX package draws from
its key (it splits the key per member, per object and per round; the test
follows the same splits) as `base=`: `log_prob` to 1e-4, samples to 1e-4,
acceptance (a count over the draws) to 1e-7, the rounding of its division. A leaky flow (no support transform, a prior box tighter
than the flow's mass) exercises the stable ordering of valid draws, the clip
and the acceptance; K = 3 members with n = 10 (K does not divide n) exercise
the per-major interleave before truncation.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synference_tpu import posterior as jpost
from synference_tpu import priors as jpriors
from synference_tpu.flows import base as jbase
from synference_tpu_torch.diagnostics import evaluate_posterior
from synference_tpu_torch.flows import base as tbase
from synference_tpu_torch.posterior import DirectPosterior, EnsemblePosterior
from synference_tpu_torch.priors import BoxUniform, priors_from_library

CFG = dict(hidden_features=16, num_transforms=3, num_bins=4)
DIM, CTX, K = 2, 4, 3
ROUNDS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _members(support, seed=0):
    cfg = dict(CFG)
    if support:
        cfg.update(support_low=(-2.0, -2.0), support_high=(2.0, 2.0))
    jflow = jbase.build_flow("nsf", DIM, CTX, **cfg)
    flow = tbase.build_flow("nsf", DIM, CTX, device="cpu", **cfg)
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-1.5, 1.5, (200, DIM)).astype(np.float32)
    x = rng.standard_normal((200, CTX)).astype(np.float32)
    members = []
    for s in range(K):
        p = jax.tree_util.tree_map(
            np.asarray, jflow.init(jax.random.PRNGKey(s), theta, x))
        for block in p["flow"]["blocks"]:
            w = block[-1]["w"]
            block[-1]["w"] = (0.1 * rng.standard_normal(w.shape)
                              ).astype(np.float32)
        members.append(p)
    return jflow, flow, members, theta, x


def _direct_base(key, m, n):
    """The normals `DirectPosterior.sample_batch_with_acceptance` draws in
    the JAX package: (M, ROUNDS·n, D)."""
    out = []
    for k in jax.random.split(key, m):
        out.append(np.concatenate([
            np.asarray(jax.random.normal(kk, (n, DIM)))
            for kk in jax.random.split(k, ROUNDS)]))
    return np.stack(out)


# -- priors -------------------------------------------------------------
def test_box_uniform_matches_jax():
    low, high = [8.0, 0.0, -1.0], [11.0, 2.0, 1.0]
    ref = jpriors.BoxUniform(low, high, ("a", "b", "c"))
    box = BoxUniform(low, high, ("a", "b", "c"), device="cpu")
    pts = np.array([[8.0, 0.0, -1.0], [11.0, 2.0, 1.0], [9.0, 1.0, 0.0],
                    [7.999, 1.0, 0.0], [9.0, 2.0001, 0.0], [9.0, 1.0, -1.5]],
                   np.float32)
    np.testing.assert_array_equal(box.support_mask(pts).numpy(),
                                  np.asarray(ref.support_mask(pts)))
    assert box.support_mask(pts).tolist() == [True, True, True, False,
                                              False, False]  # closed bounds
    np.testing.assert_allclose(box.log_prob(pts).numpy(),
                               np.asarray(ref.log_prob(pts)), rtol=1e-6)
    assert box.dim == ref.dim == 3
    assert box.to_dict() == ref.to_dict()
    again = BoxUniform.from_dict(ref.to_dict(), "cpu")
    assert again.names == ("a", "b", "c")
    assert torch.equal(again.low, box.low) and torch.equal(again.high,
                                                           box.high)
    s = box.sample(torch.Generator().manual_seed(0), 5000)
    assert s.shape == (5000, 3) and box.support_mask(s).all()
    np.testing.assert_allclose(s.mean(0).numpy(), [9.5, 1.0, 0.0], atol=0.06)
    with pytest.raises(ValueError, match="high > low"):
        BoxUniform([0.0, 1.0], [1.0, 1.0], device="cpu")


@pytest.mark.parametrize("kw", [
    {}, {"extend_pct": 0.1, "positive_params": ("redshift",)},
    {"overrides": {"log10_mass": (7.0, 12.0)}, "extend_pct": 0.05}])
def test_priors_from_library_matches_jax(kw):
    rng = np.random.default_rng(0)
    params = np.stack([rng.uniform(8, 11, 300), rng.uniform(0.01, 3, 300),
                       rng.uniform(-2, 2, 300)]).astype(np.float32)
    names = ["log10_mass", "redshift", "tau_v"]
    for arr in (params, params.T):  # (P, N) and (N, P)
        ref = jpriors.priors_from_library(arr, names, **kw)
        box = priors_from_library(arr, names, device="cpu", **kw)
        np.testing.assert_array_equal(box.low.numpy(), np.asarray(ref.low))
        np.testing.assert_array_equal(box.high.numpy(), np.asarray(ref.high))
        assert box.names == ref.names


# -- posteriors -----------------------------------------------------------
@pytest.mark.parametrize("support", [False, True])
def test_direct_posterior_matches_jax(support):
    jflow, flow, members, theta, x = _members(support)
    lo, hi = (-2.0, -2.0), (2.0, 2.0)
    jprior = jpriors.BoxUniform(lo, hi)
    prior = BoxUniform(lo, hi, device="cpu")
    ref = jpost.DirectPosterior(
        jflow, jax.tree_util.tree_map(jnp.asarray, members[0]), jprior)
    post = DirectPosterior(flow, tbase.params_from_numpy(members[0], "cpu"),
                           prior)
    pts = theta[:50].copy()
    pts[:5] += 5.0  # outside the box
    lp = post.log_prob(pts, x[:50]).numpy()
    lp_ref = np.asarray(ref.log_prob(pts, x[:50]))
    assert np.isneginf(lp[:5]).all() and np.isfinite(lp[5:]).all()
    np.testing.assert_array_equal(np.isneginf(lp), np.isneginf(lp_ref))
    np.testing.assert_allclose(lp[5:], lp_ref[5:], atol=1e-4)
    key = jax.random.PRNGKey(3)
    n, m = 12, 6
    base = _direct_base(key, m, n)
    s, acc = post.sample_batch_with_acceptance(x[:m], n, base=base)
    s_ref, acc_ref = ref.sample_batch_with_acceptance(key, x[:m], n)
    assert s.shape == (m, n, DIM)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_ref), atol=1e-7)
    if support:
        assert (acc == 1.0).all()
    # the Monte-Carlo normaliser from shared normals
    keys = jax.random.split(key, 50)
    nbase = np.stack([np.asarray(jax.random.normal(k, (64, DIM)))
                      for k in keys])
    accept = post._acceptance(torch.as_tensor(x[:50]), 64, base=nbase)
    lp_norm = np.asarray(ref.log_prob(pts, x[:50], normalize=True, key=key,
                                      n_norm=64))
    np.testing.assert_allclose(
        (torch.as_tensor(lp) - torch.log(accept.clamp(min=1e-6)))[5:].numpy(),
        lp_norm[5:], atol=1e-4)
    own = post.log_prob(pts, x[:50], normalize=True,
                        generator=torch.Generator().manual_seed(0), n_norm=64)
    assert (own[5:] >= torch.as_tensor(lp[5:]) - 1e-6).all()


def test_leaky_flow_ordering_clip_and_acceptance():
    jflow, flow, members, theta, x = _members(support=False)
    lo, hi = (-0.4, -0.3), (0.5, 0.6)  # much tighter than the flow's mass
    ref = jpost.DirectPosterior(
        jflow, jax.tree_util.tree_map(jnp.asarray, members[1]),
        jpriors.BoxUniform(lo, hi))
    post = DirectPosterior(flow, tbase.params_from_numpy(members[1], "cpu"),
                           BoxUniform(lo, hi, device="cpu"))
    key = jax.random.PRNGKey(11)
    n, m = 32, 8
    base = _direct_base(key, m, n)
    s, acc = post.sample_batch_with_acceptance(x[:m], n, base=base)
    s_ref, acc_ref = ref.sample_batch_with_acceptance(key, x[:m], n)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_ref), atol=1e-7)
    assert 0.0 < float(acc.mean()) < 0.5  # most raw draws leak
    assert (s >= torch.tensor(lo)).all() and (s <= torch.tensor(hi)).all()
    # objects with fewer than n valid draws end in clipped ones, on a face
    short = (acc * ROUNDS * n < n)
    assert short.any()
    on_face = ((s == torch.tensor(lo)) | (s == torch.tensor(hi))).any(-1)
    assert on_face[short][:, -1].all()
    # the valid draws come first, in the order they were drawn
    raw = flow.sample_batch(post.params, x[:m], ROUNDS * n, base=base)
    for i in range(m):
        valid = post.prior.support_mask(raw[i])
        kept = raw[i][valid][:n]
        np.testing.assert_array_equal(s[i, :len(kept)].numpy(), kept.numpy())
    # evaluate_posterior surfaces the leak and warns
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        report = evaluate_posterior(post, x[:m], theta[:m], n_samples=n)
    assert report["frac_clipped"] > 0.5
    assert report["sampling_acceptance_min"] <= report[
        "sampling_acceptance_mean"]
    assert any("leakage" in str(wi.message) for wi in w)


@pytest.mark.parametrize("support", [False, True])
def test_ensemble_posterior_matches_jax(support):
    jflow, flow, members, theta, x = _members(support)
    lo, hi = (-2.0, -2.0), (2.0, 2.0)
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *members)
    ref = jpost.EnsemblePosterior(
        jflow, jax.tree_util.tree_map(jnp.asarray, stacked),
        jpriors.BoxUniform(lo, hi), K)
    post = EnsemblePosterior(flow, tbase.params_from_numpy(stacked, "cpu"),
                             BoxUniform(lo, hi, device="cpu"))
    assert post.n_members == K
    pts = theta[:40].copy()
    pts[:3] -= 4.0
    lp = post.log_prob(pts, x[:40]).numpy()
    lp_ref = np.asarray(ref.log_prob(pts, x[:40]))
    assert np.isneginf(lp[:3]).all()
    np.testing.assert_allclose(lp[3:], lp_ref[3:], atol=1e-4)
    # n = 10 draws from K = 3 members: per = 4, 12 interleaved, 10 kept
    key = jax.random.PRNGKey(21)
    n, m, per = 10, 5, 4
    base = np.stack([_direct_base(k, m, per)
                     for k in jax.random.split(key, K)])
    assert base.shape == (K, m, ROUNDS * per, DIM)
    s, acc = post.sample_batch_with_acceptance(x[:m], n, base=base)
    s_ref, acc_ref = ref.sample_batch_with_acceptance(key, x[:m], n)
    assert s.shape == (m, n, DIM)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_ref), atol=1e-7)
    np.testing.assert_array_equal(
        post.sample_batch(x[:m], n, base=base).numpy(), s.numpy())
    # draw j of the result is draw j // K of member j % K
    for k in range(K):
        member = DirectPosterior(
            flow, tbase.params_from_numpy(members[k], "cpu"), post.prior)
        own = member.sample_batch(x[:m], per, base=base[k])
        np.testing.assert_allclose(s[:, k::K].numpy(),
                                   own[:, :len(range(k, n, K))].numpy(),
                                   atol=1e-6)


def test_interleave_keeps_every_member_when_k_does_not_divide_n():
    """Members that draw around 10·k: truncation to n drops at most one
    draw per member."""
    flow = tbase.build_flow("nsf", 2, 4, device="cpu", **CFG)
    k_members = 5
    g = torch.Generator().manual_seed(0)
    params = flow.init(g, None, None, n_members=k_members)
    params["theta_mean"] = 10.0 * torch.arange(
        k_members, dtype=torch.float32)[:, None].expand(-1, 2).clone()
    params["theta_std"] = torch.full((k_members, 2), 0.01)
    prior = BoxUniform([-1.0, -1.0], [50.0, 50.0], device="cpu")
    post = EnsemblePosterior(flow, params, prior)
    s, acc = post.sample_batch_with_acceptance(torch.zeros(3, 4), 12, g)
    assert s.shape == (3, 12, 2) and torch.allclose(acc, torch.ones(3))
    member_of = torch.round(s[..., 0] / 10.0).long()
    for m in range(3):
        ids, counts = np.unique(member_of[m].numpy(), return_counts=True)
        assert set(ids) == set(range(k_members))
        assert counts.min() >= 2 and counts.max() <= 3


def test_single_condition_sampling_and_map():
    _, flow, members, theta, x = _members(support=False)
    prior = BoxUniform((-1.0, -1.0), (1.0, 1.0), device="cpu")
    g = torch.Generator().manual_seed(5)
    post = DirectPosterior(flow, tbase.params_from_numpy(members[0], "cpu"),
                           prior)
    s = post.sample(x[0], 300, g)
    assert s.shape == (300, DIM) and prior.support_mask(s).all()
    best = post.map_estimate(x[0], g, n_starts=128)
    assert best.shape == (DIM,) and prior.support_mask(best).all()
    # a box the flow never reaches: the fallback clips into it
    far = DirectPosterior(flow, post.params,
                          BoxUniform((50.0, 50.0), (51.0, 51.0), device="cpu"))
    s = far.sample(x[0], 20, g, max_tries=2)
    assert s.shape == (20, DIM) and far.prior.support_mask(s).all()
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *members)
    ens = EnsemblePosterior(flow, tbase.params_from_numpy(stacked, "cpu"),
                            prior)
    s = ens.sample(x[0], 200, g)
    assert s.shape == (200, DIM) and prior.support_mask(s).all()
    with pytest.raises(ValueError, match="generator or base"):
        ens.sample_batch(x[:2], 4)
