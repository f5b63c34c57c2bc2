"""Port parity, diagnostics: every metric of `diagnostics.py` against the
JAX package's functions on shared sample arrays and shared reference-point
uniforms, to 1e-6 (counts and their means are exact; float32 means and
quantiles differ in the order of their sums).

The sample count is even in one case and odd in the other: `jnp.median` and
`jnp.quantile` interpolate between the two middle order statistics, where
`torch.median` would take the lower one. Standard deviations and variances
are population ones.

The JAX package keeps the metric chain twice, fused into one program
(`_fused_metric_chain`) and as a general multi-program path, because of its
dispatch cost; the port has one chain on device tensors, held here against
the fused one through a stand-in posterior that returns given samples. The
whole reports of `evaluate_posterior` and `evaluate_members_fused` (with
`stat()`'s ddof = 1 and 1.96·std/√K) are compared on a small real flow from
shared normals, to 2e-5 (the reports round to 5 decimals).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synference_tpu import diagnostics as jd
from synference_tpu import posterior as jpost
from synference_tpu import priors as jpriors
from synference_tpu.flows import base as jbase
from synference_tpu_torch import diagnostics as td
from synference_tpu_torch.flows import base as tbase
from synference_tpu_torch.posterior import DirectPosterior
from synference_tpu_torch.priors import BoxUniform

TOL = dict(rtol=1e-6, atol=1e-6)


def _samples(s, m=60, p=3, seed=0):
    """Posterior draws around noisy truths: neither calibrated nor far off,
    so that no metric saturates."""
    rng = np.random.default_rng(seed)
    truths = rng.uniform(-1, 1, (m, p)).astype(np.float32)
    centre = truths + 0.3 * rng.standard_normal((m, p))
    samples = (centre[:, None, :] + 0.35 * rng.standard_normal((m, s, p))
               * np.array([1.0, 2.0, 0.5])).astype(np.float32)
    return samples, truths


@pytest.fixture(params=[64, 101], ids=["even", "odd"])
def data(request):
    return _samples(request.param)


def test_pit_and_ranks(data):
    samples, truths = data
    pit = td.pit_values(samples, truths, device="cpu")
    np.testing.assert_allclose(pit.numpy(),
                               np.asarray(jd.pit_values(samples, truths)),
                               **TOL)
    np.testing.assert_array_equal(
        td.sbc_ranks(samples, truths, device="cpu").numpy(),
        np.asarray(jd.sbc_ranks(samples, truths)))
    np.testing.assert_allclose(td.pit_ks_statistic(pit, device="cpu"),
                               jd.pit_ks_statistic(np.asarray(pit)), **TOL)


@pytest.mark.parametrize("norm", [True, False])
def test_tarp(data, norm):
    samples, truths = data
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, truths.shape))
    alphas, ecp = td.tarp_coverage(samples, truths, uniforms=u, norm=norm,
                                   device="cpu")
    ref_a, ref_e = jd.tarp_coverage(samples, truths, key=key, norm=norm)
    np.testing.assert_allclose(alphas, ref_a, **TOL)
    np.testing.assert_allclose(ecp, ref_e, **TOL)
    if norm:
        assert td.tarp_deviation(
            samples, truths, uniforms=u, device="cpu") == pytest.approx(
                jd.tarp_deviation(samples, truths, key=key), abs=1e-6)
    # from a generator: another curve of the same kind
    _, own = td.tarp_coverage(samples, truths,
                              torch.Generator().manual_seed(0), norm=norm,
                              device="cpu")
    assert own.shape == ecp.shape and own[0] == 0.0 and own[-1] <= 1.0


def test_coverage_and_point_metrics(data):
    samples, truths = data
    np.testing.assert_allclose(
        td.expected_coverage(samples, truths, device="cpu"),
        jd.expected_coverage(samples, truths), **TOL)
    out = td.point_metrics(samples, truths, device="cpu")
    ref = jd.point_metrics(samples, truths)
    assert sorted(out) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(out[key], ref[key], err_msg=key, **TOL)


def test_median_interpolates_on_an_even_count():
    samples = np.array([[[1.0], [2.0], [4.0], [8.0]]], np.float32)
    truths = np.array([[3.0]], np.float32)
    # the interpolated median is 3 (torch.median would give 2)
    assert td.point_metrics(samples, truths, device="cpu")["bias"][0] == 0.0
    assert jd.point_metrics(samples, truths)["bias"][0] == 0.0


class _Given:
    """A JAX posterior that returns given samples, acceptance, log-probs."""

    def __init__(self, samples, acc, lp):
        self.samples, self.acc, self.lp = samples, acc, lp

    def sample_batch_with_acceptance(self, key, xs, n, rounds):
        return jnp.asarray(self.samples), jnp.asarray(self.acc)

    def log_prob(self, truths, xs):
        return jnp.asarray(self.lp)


def test_metric_chain_matches_the_fused_chain(data):
    samples, truths = data
    m = len(truths)
    rng = np.random.default_rng(1)
    acc = rng.uniform(0.3, 1.0, m).astype(np.float32)
    lp = rng.normal(-2.0, 1.0, m).astype(np.float32)
    lp[:4] = -np.inf  # truths outside the support
    levels = (0.5, 0.68, 0.9, 0.95)
    key = jax.random.PRNGKey(8)
    _, k_tarp = jax.random.split(key)
    u = np.asarray(jax.random.uniform(k_tarp, truths.shape))
    ref = jax.device_get(jd._fused_metric_chain(
        _Given(samples, acc, lp), key, jnp.zeros((m, 1)),
        jnp.asarray(truths), samples.shape[1], 4, levels))
    out = td._to_numpy(td._metric_chain(
        torch.as_tensor(samples), torch.as_tensor(acc),
        torch.as_tensor(truths), torch.as_tensor(lp), torch.as_tensor(u),
        levels))
    assert sorted(out) == sorted(ref)
    for key_ in ref:
        if key_ == "point":
            for name in ref["point"]:
                np.testing.assert_allclose(out["point"][name],
                                           ref["point"][name], err_msg=name,
                                           **TOL)
        else:
            np.testing.assert_allclose(out[key_], ref[key_], err_msg=key_,
                                       **TOL)
    # with a leading member axis the chain gives each member's own numbers
    two = td._to_numpy(td._metric_chain(
        torch.as_tensor(np.stack([samples, samples[::-1].copy()])),
        torch.as_tensor(np.stack([acc, acc[::-1].copy()])),
        torch.as_tensor(truths), torch.as_tensor(np.stack([lp, lp])),
        torch.as_tensor(np.stack([u, u])), levels))
    np.testing.assert_allclose(two["pit_ks"][0], out["pit_ks"], **TOL)
    np.testing.assert_allclose(two["tarp_deviation"][0],
                               out["tarp_deviation"], **TOL)
    np.testing.assert_allclose(two["point"]["r2"][0], out["point"]["r2"],
                               **TOL)
    assert not np.allclose(two["point"]["r2"][1], out["point"]["r2"])


# -- whole reports on a small real flow ------------------------------------
CFG = dict(hidden_features=16, num_transforms=3, num_bins=4,
           support_low=(-2.0, -2.0), support_high=(2.0, 2.0))
K, M, N, ROUNDS, DIM = 3, 24, 16, 4, 2


def _flow_and_members():
    jflow = jbase.build_flow("nsf", DIM, 3, **CFG)
    flow = tbase.build_flow("nsf", DIM, 3, device="cpu", **CFG)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    theta = np.clip(np.stack([x[:, 0], x[:, 1] - x[:, 2]], axis=1)
                    + 0.3 * rng.standard_normal((200, 2)), -1.9,
                    1.9).astype(np.float32)
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


def _chain_draws(key, m, n):
    """What the JAX chain draws from `key`: the sampler's base normals
    (M, ROUNDS·n, D) and TARP's uniforms (M, D)."""
    k_samp, k_tarp = jax.random.split(key)
    base = np.stack([
        np.concatenate([np.asarray(jax.random.normal(kk, (n, DIM)))
                        for kk in jax.random.split(k, ROUNDS)])
        for k in jax.random.split(k_samp, m)])
    return base, np.asarray(jax.random.uniform(k_tarp, (m, DIM)))


def _assert_reports_equal(out, ref, path=""):
    assert sorted(out) == sorted(ref), path
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_reports_equal(out[key], ref[key], f"{path}/{key}")
        elif isinstance(ref[key], (list, float, int)) and key not in (
                "parameter_names",):
            np.testing.assert_allclose(out[key], ref[key], atol=2e-5,
                                       err_msg=f"{path}/{key}")
        else:
            assert out[key] == ref[key], f"{path}/{key}"


def test_evaluate_posterior_report_matches_jax():
    jflow, flow, members, theta, x = _flow_and_members()
    lo, hi = CFG["support_low"], CFG["support_high"]
    ref_post = jpost.DirectPosterior(
        jflow, jax.tree_util.tree_map(jnp.asarray, members[0]),
        jpriors.BoxUniform(lo, hi))
    post = DirectPosterior(flow, tbase.params_from_numpy(members[0], "cpu"),
                           BoxUniform(lo, hi, device="cpu"))
    key = jax.random.PRNGKey(2)
    base, u = _chain_draws(key, M, N)
    ref = jd.evaluate_posterior(ref_post, x[:M], theta[:M], key=key,
                                n_samples=N, parameter_names=["a", "b"])
    out = td.evaluate_posterior(post, x[:M], theta[:M], n_samples=N,
                                parameter_names=["a", "b"], base=base,
                                tarp_uniforms=u)
    _assert_reports_equal(out, ref)
    assert out["sampling_acceptance_min"] == 1.0
    text = td.format_report(out)
    assert text == jd.format_report(
        {**ref, "mean_log_prob": out["mean_log_prob"]})
    # from a generator alone: the same keys, finite numbers
    own = td.evaluate_posterior(post, x[:M], theta[:M], n_samples=N)
    assert sorted(own) == sorted(k for k in ref if k != "parameter_names")
    assert np.isfinite(own["pit_ks"]).all()


def test_evaluate_members_report_and_stat_match_jax():
    jflow, flow, members, theta, x = _flow_and_members()
    lo, hi = CFG["support_low"], CFG["support_high"]
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *members)
    key = jax.random.PRNGKey(6)
    draws = [_chain_draws(k, M, N) for k in jax.random.split(key, K)]
    ref = jd.evaluate_members_fused(
        jflow, jax.tree_util.tree_map(jnp.asarray, stacked),
        jpriors.BoxUniform(lo, hi), x[:M], theta[:M], key=key, n_samples=N,
        parameter_names=["a", "b"])
    out = td.evaluate_members_fused(
        flow, tbase.params_from_numpy(stacked, "cpu"),
        BoxUniform(lo, hi, device="cpu"), x[:M], theta[:M], n_samples=N,
        parameter_names=["a", "b"], base=np.stack([d[0] for d in draws]),
        tarp_uniforms=np.stack([d[1] for d in draws]))
    _assert_reports_equal(out, ref)
    # stat(): sample standard deviation (ddof 1) and 1.96·std/√K
    r2 = np.asarray(out["r2"]["per_member"])
    np.testing.assert_allclose(out["r2"]["std"], np.std(r2, axis=0, ddof=1),
                               atol=2e-5)
    np.testing.assert_allclose(
        out["r2"]["ci95"], 1.96 * np.std(r2, axis=0, ddof=1) / np.sqrt(K),
        atol=2e-5)
    assert out["n_members"] == K and out["n_samples"] == N
