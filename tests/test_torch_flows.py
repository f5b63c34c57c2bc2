"""Port parity, flows: `flows/mlp.py`, `flows/nsf.py` and `flows/base.py`
against the JAX package on the same numpy inputs and the same weights.

The JAX parameter tree goes through `params_from_numpy`; where a function
draws, the base normals that JAX draws from its key are computed in the test
and given to the port as `base=`. Small sizes: hidden 16, 3 transforms, 4
bins, θ dim 1, 2, 5, context 0 and 4, K = 1 and 3 members.

Tolerances (absolute, float32): spline knots, `y` and `logdet` 1e-5 on raw
conditioner outputs of scale 0.5 (at larger scales the fp32 spline itself is
ill-conditioned, in both packages); `log_prob` and samples 1e-4; gradients
1e-4 relative on the norm of each leaf.

Dropped TPU workaround: the JAX package finds a point's bin with a one-hot
product of comparisons (`_bin_onehot`, gathers serialise poorly on the VPU);
the port uses `torch.searchsorted` and one `gather`. The edges are the same:
knot_k <= x < knot_{k+1}, the last bin at or beyond the last knot, the first
below the first knot; the tests put points on knots, at ±tail_bound and
outside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synference_tpu.flows import base as jbase
from synference_tpu.flows import nsf as jnsf
from synference_tpu_torch.flows import base as tbase
from synference_tpu_torch.flows import nsf as tnsf
from synference_tpu_torch.flows.mlp import mlp_apply, mlp_init

BINS, TAIL = 4, 3.5
CFG = dict(hidden_features=16, num_transforms=3, num_bins=BINS)
DIMS = [(1, 0), (1, 4), (2, 0), (2, 4), (5, 0), (5, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params, seed, scale=0.3):
    """JAX params (numpy tree) with every zero last layer made random, so
    that the flow is not the identity."""
    rng = np.random.default_rng(seed)
    params = _np(params)
    blocks = params["flow"]["blocks"] if "flow" in params else params["blocks"]
    for block in blocks:
        w = block[-1]["w"]
        block[-1]["w"] = (scale * rng.standard_normal(w.shape)
                          / np.sqrt(w.shape[1])).astype(np.float32)
        block[-1]["b"] = (scale * rng.standard_normal(
            block[-1]["b"].shape)).astype(np.float32)
    return params


def _stack(trees):
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)


def _data(dim, ctx, n=64, seed=0):
    rng = np.random.default_rng(seed)
    theta = (1.5 * rng.standard_normal((n, dim))).astype(np.float32)
    x = rng.standard_normal((n, ctx)).astype(np.float32)
    return theta, x


def _raw_and_points(seed=0, n=400):
    rng = np.random.default_rng(seed)
    raw = (0.5 * rng.standard_normal((n, 3 * BINS + 1))).astype(np.float32)
    knots_w, knots_h, *_ = jnsf._spline_params(jnp.asarray(raw), BINS, TAIL)
    x = (2.0 * rng.standard_normal(n)).astype(np.float32)
    y = x.copy()
    # points on knots (every bin edge in turn), at the bounds and outside
    for i in range(100):
        x[i] = np.asarray(knots_w)[i, i % (BINS + 1)]
        y[i] = np.asarray(knots_h)[i, i % (BINS + 1)]
    for arr in (x, y):
        arr[100:104] = [TAIL, -TAIL, np.nextafter(np.float32(TAIL), 0), 0.0]
        arr[104:110] = [4.0, -4.0, 3.6, -17.0, 100.0, -3.5001]
    return raw, x, y


def test_spline_params_match_jax():
    raw, _, _ = _raw_and_points()
    ref = jnsf._spline_params(jnp.asarray(raw), BINS, TAIL)
    out = tnsf._spline_params(torch.as_tensor(raw), BINS, TAIL)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
    # boundary derivatives are pinned to 1, and raw = 0 gives derivative 1
    assert (out[2][:, 0] == 1).all() and (out[2][:, -1] == 1).all()
    d0 = tnsf._spline_params(torch.zeros(1, 3 * BINS + 1), BINS, TAIL)[2]
    np.testing.assert_allclose(d0.numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_rqs_matches_jax(direction):
    raw, x, y = _raw_and_points()
    pts = x if direction == "forward" else y
    jfn = jnsf.rqs_forward if direction == "forward" else jnsf.rqs_inverse
    tfn = tnsf.rqs_forward if direction == "forward" else tnsf.rqs_inverse
    ref, ref_ld = jfn(jnp.asarray(pts), jnp.asarray(raw), BINS, TAIL)
    out, out_ld = tfn(torch.as_tensor(pts), torch.as_tensor(raw), BINS, TAIL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(out_ld.numpy(), np.asarray(ref_ld), atol=1e-5)
    # outside the open interval the spline is the identity (strict bounds)
    outside = np.abs(pts) >= TAIL
    assert outside.sum() >= 8
    np.testing.assert_array_equal(out.numpy()[outside], pts[outside])
    np.testing.assert_array_equal(out_ld.numpy()[outside], 0.0)


def test_rqs_inverse_undoes_forward():
    raw, x, _ = _raw_and_points(seed=1)
    raw_t, x_t = torch.as_tensor(raw), torch.as_tensor(x)
    y, ld = tnsf.rqs_forward(x_t, raw_t, BINS, TAIL)
    back, ld_inv = tnsf.rqs_inverse(y, raw_t, BINS, TAIL)
    np.testing.assert_allclose(back.numpy(), x, atol=2e-4)
    np.testing.assert_allclose((ld + ld_inv).numpy(), 0.0, atol=5e-4)


def test_spline_gradient_is_finite_on_clipped_points():
    """The untaken branch of the inside/outside selects puts no NaN into
    the gradient."""
    raw, x, _ = _raw_and_points()
    raw_t = torch.as_tensor(raw).requires_grad_()
    x_t = torch.as_tensor(x).requires_grad_()
    y, ld = tnsf.rqs_forward(x_t, raw_t, BINS, TAIL)
    (y.sum() + ld.sum()).backward()
    assert torch.isfinite(raw_t.grad).all() and torch.isfinite(x_t.grad).all()


def test_mlp_init_and_apply():
    g = torch.Generator().manual_seed(0)
    layers = mlp_init(g, [40, 64, 64, 6], n_members=3)
    assert [tuple(l["w"].shape) for l in layers] == [
        (3, 64, 40), (3, 64, 64), (3, 6, 64)]
    assert all((l["b"] == 0).all() for l in layers)
    assert (layers[-1]["w"] == 0).all()  # identity flow at the start
    # He init: std = sqrt(2 / fan_in), members differ
    assert abs(float(layers[0]["w"].std()) / np.sqrt(2 / 40) - 1) < 0.05
    assert abs(float(layers[1]["w"].std()) / np.sqrt(2 / 64) - 1) < 0.05
    assert not torch.equal(layers[0]["w"][0], layers[0]["w"][1])
    layers = mlp_init(g, [5, 8, 3], n_members=2, zero_last=False)
    x = torch.randn(2, 7, 5, generator=g)
    out = mlp_apply(layers, x)
    from synference_tpu.flows.mlp import mlp_apply as jmlp
    for k in range(2):
        ref = jmlp([{n: jnp.asarray(v[k].numpy()) for n, v in l.items()}
                    for l in layers], jnp.asarray(x[k].numpy()))
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("dim,ctx", DIMS)
def test_make_nsf_matches_jax(dim, ctx):
    init, jlog_prob, jsample = jnsf.make_nsf(dim, ctx, **CFG)
    net = tnsf.make_nsf(dim, ctx, **CFG, device="cpu")
    members = [_perturbed(init(jax.random.PRNGKey(s)), s) for s in range(3)]
    params = tbase.params_from_numpy(_stack(members), "cpu")
    theta, x = _data(dim, ctx)
    th_t = torch.as_tensor(theta).expand(3, -1, -1)
    x_t = torch.as_tensor(x).expand(3, -1, -1)
    lp = net.log_prob(params, th_t, x_t)
    key = jax.random.PRNGKey(5)
    base = np.asarray(jax.random.normal(key, (len(x), dim)))
    drawn = net.inverse(params, torch.as_tensor(base).expand(3, -1, -1), x_t)
    for k, member in enumerate(members):
        ref = jlog_prob(member, jnp.asarray(theta), jnp.asarray(x))
        np.testing.assert_allclose(lp[k].numpy(), np.asarray(ref), atol=1e-4)
        ref = jsample(member, key, jnp.asarray(x), len(x))
        np.testing.assert_allclose(drawn[k].numpy(), np.asarray(ref),
                                   atol=1e-4)
    # forward undoes inverse
    back, _ = net.forward(params, drawn, x_t)
    np.testing.assert_allclose(back.numpy(), np.broadcast_to(base, back.shape),
                               atol=2e-4)


def _flow_pair(dim, ctx, support):
    cfg = dict(CFG)
    if support:
        cfg.update(support_low=(-6.0,) * dim, support_high=(7.0,) * dim)
    return (jbase.build_flow("nsf", dim, ctx, **cfg),
            tbase.build_flow("nsf", dim, ctx, device="cpu", **cfg))


@pytest.mark.parametrize("support", [False, True])
@pytest.mark.parametrize("dim,ctx", [(1, 4), (2, 0), (5, 4)])
def test_conditional_flow_matches_jax(dim, ctx, support):
    jflow, flow = _flow_pair(dim, ctx, support)
    theta, x = _data(dim, ctx)
    members = [_perturbed(jflow.init(jax.random.PRNGKey(s), theta, x), s)
               for s in range(3)]
    # the statistics of the training set are the population ones
    own = flow.init(torch.Generator().manual_seed(0), theta, x, n_members=3)
    for name in ("theta_mean", "theta_std", "x_mean", "x_std"):
        np.testing.assert_allclose(own[name][1].numpy(), members[0][name],
                                   rtol=2e-5, atol=1e-6)
    params = tbase.params_from_numpy(_stack(members), "cpu")
    lp = flow.log_prob(params, theta, x)  # (3, B)
    key = jax.random.PRNGKey(9)
    n = 16
    # sample_batch splits the key per object; each object draws (n, dim)
    keys = jax.random.split(key, 8)
    base = np.stack([np.asarray(jax.random.normal(k, (n, dim)))
                     for k in keys])
    drawn = flow.sample_batch(params, x[:8], n,
                              base=np.broadcast_to(base, (3,) + base.shape))
    assert drawn.shape == (3, 8, n, dim)
    for k, member in enumerate(members):
        ref = jflow.log_prob(member, theta, x)
        np.testing.assert_allclose(lp[k].numpy(), np.asarray(ref), atol=1e-4)
        ref = jflow.sample_batch(member, key, x[:8], n)
        np.testing.assert_allclose(drawn[k].numpy(), np.asarray(ref),
                                   atol=1e-4)
        # one member's parameters, without the member axis
        single = tbase.params_from_numpy(member, "cpu")
        np.testing.assert_allclose(
            flow.log_prob(single, theta, x).numpy(), lp[k].numpy(), atol=1e-6)
        one = flow.sample(single, x[0], n, base=base[0])
        np.testing.assert_allclose(one.numpy(), drawn[k, 0].numpy(),
                                   atol=1e-6)
    if support:
        assert (drawn > -6.0).all() and (drawn < 7.0).all()
    # to_base undoes sample_batch
    flat = drawn.reshape(3, 8 * n, dim)
    back = flow.to_base(params, flat, np.repeat(x[:8], n, axis=0))
    np.testing.assert_allclose(back.numpy().reshape(3, 8, n, dim),
                               np.broadcast_to(base, (3,) + base.shape),
                               atol=5e-4)


def test_identity_at_initialisation():
    """Zero last layers: the flow starts as the identity map, so log_prob
    is the standard normal's in standardised units and a sample is its base
    draw scaled back."""
    flow = tbase.build_flow("nsf", 5, 4, device="cpu", **CFG)
    theta, x = _data(5, 4, n=200)
    g = torch.Generator().manual_seed(0)
    params = flow.init(g, theta, x, n_members=2)
    z = (torch.as_tensor(theta) - params["theta_mean"][0]) / params[
        "theta_std"][0]
    ref = (-0.5 * (z * z).sum(-1) - 2.5 * np.log(2 * np.pi)
           - torch.log(params["theta_std"][0]).sum())
    lp = flow.log_prob(params, theta, x)
    np.testing.assert_allclose(lp[0].numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(lp[1].numpy(), ref.numpy(), atol=1e-5)
    base = torch.randn(2, 3, 7, 5, generator=g)
    s = flow.sample_batch(params, x[:3], 7, base=base)
    # at the identity a draw is its base normals, scaled back, in the order
    # the permutations leave them: the sorted values are the same
    inv = (s - params["theta_mean"][:, None, None]) / params[
        "theta_std"][:, None, None]
    np.testing.assert_allclose(np.sort(inv.numpy(), -1),
                               np.sort(base.numpy(), -1), atol=1e-5)


@pytest.mark.parametrize("support", [False, True])
def test_gradients_match_jax(support):
    dim, ctx = 5, 4
    jflow, flow = _flow_pair(dim, ctx, support)
    theta, x = _data(dim, ctx, n=128)
    member = _perturbed(jflow.init(jax.random.PRNGKey(0), theta, x), 0)
    jparams = jax.tree_util.tree_map(jnp.asarray, member)
    ref = jax.grad(lambda p: jflow.log_prob(p, theta, x).mean())(jparams)
    params = tbase.tree_map(lambda a: a.requires_grad_(),
                            tbase.params_from_numpy(member, "cpu"))
    flow.log_prob(params, theta, x).mean().backward()
    ref_flat = jbase.flatten_params(ref)
    leaves = dict(tbase._leaves_with_path(params))
    assert sorted(leaves) == sorted(ref_flat)
    for key, leaf in leaves.items():
        r = ref_flat[key]
        err = np.linalg.norm(leaf.grad.numpy() - r)
        assert err <= 1e-4 * np.linalg.norm(r) + 1e-7, (key, err)


def test_params_round_trip_and_flat_keys():
    jflow, flow = _flow_pair(2, 4, False)
    theta, x = _data(2, 4)
    jparams = jflow.init(jax.random.PRNGKey(0), theta, x)
    tree = _np(jparams)
    params = tbase.params_from_numpy(tree, "cpu")
    back = tbase.params_to_numpy(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    flat = tbase.flatten_params(params)
    ref = jbase.flatten_params(jparams)
    assert list(flat) == list(ref)
    for key in ref:
        np.testing.assert_array_equal(flat[key], ref[key])
    again = tbase.unflatten_params(params, flat)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           tbase.params_to_numpy(again), tree)
    # the port's own init has the JAX package's structure and shapes
    own = flow.init(torch.Generator().manual_seed(0), theta, x)
    assert ({k: v.shape for k, v in tbase.flatten_params(own).items()}
            == {k: v.shape for k, v in ref.items()})


def test_spec_round_trip_and_unported_models():
    flow = tbase.build_flow("nsf", 3, 2, device="cpu", **CFG,
                            support_low=(0, 0, 0), support_high=(1, 2, 3))
    spec = flow.spec()
    jspec = jbase.build_flow("nsf", 3, 2, **CFG, support_low=(0, 0, 0),
                             support_high=(1, 2, 3)).spec()
    assert spec == jspec
    again = tbase.ConditionalFlow.from_spec(spec, "cpu")
    assert again.spec() == spec
    # the names that were refused before the rest of the zoo was ported
    # build now, with the JAX package's spec
    for name in ("maf", "mdn", "ncsf", "cnf", "realnvp"):
        flow = tbase.build_flow(name, 3, 2, device="cpu", hidden_features=8)
        assert flow.spec() == jbase.build_flow(name, 3, 2,
                                               hidden_features=8).spec()
        assert tbase.ConditionalFlow.from_spec(flow.spec(),
                                               "cpu").spec() == flow.spec()
    # the embedding net is ported: its configuration rides the spec
    emb = tbase.build_flow("nsf", 3, 40, device="cpu", **CFG, embedding_dim=8,
                           embedding_hidden=12)
    spec = emb.spec()
    assert spec == jbase.build_flow("nsf", 3, 40, **CFG, embedding_dim=8,
                                    embedding_hidden=12).spec()
    again = tbase.ConditionalFlow.from_spec(spec, "cpu")
    params = again.init(torch.Generator().manual_seed(0))
    assert [tuple(layer["w"].shape) for layer in params["embed"]] == [
        (12, 40), (12, 12), (8, 12)]
    with pytest.raises(ValueError, match="unknown flow model"):
        tbase.build_flow("nope", 3, 2, device="cpu")
    with pytest.raises(ValueError, match="come together"):
        tbase.build_flow("nsf", 3, 2, device="cpu", support_low=(0, 0, 0))


@pytest.mark.parametrize("layers", [1, 2])
def test_embedding_net_matches_jax(layers):
    """The embedding net (`embedding_dim`) with the JAX package's weights:
    log_prob and samples at the NSF's bound (1e-4), the JAX tree layout
    ("embed": [{"w", "b"}, ...], He-initialised, no zero last layer) and
    gradients through the embedding."""
    cfg = dict(CFG, embedding_dim=6, embedding_hidden=16,
               embedding_layers=layers)
    jflow = jbase.build_flow("nsf", 2, 48, **cfg)
    flow = tbase.build_flow("nsf", 2, 48, device="cpu", **cfg)
    theta, x = _data(2, 48)
    members = [_perturbed(jflow.init(jax.random.PRNGKey(s), theta, x), s)
               for s in range(2)]
    own = flow.init(torch.Generator().manual_seed(0), theta, x, n_members=2)
    assert (jax.tree_util.tree_structure(members[0])
            == jax.tree_util.tree_structure(_np(tbase.params_to_numpy(
                tbase._member(own, 0)))))
    assert float(own["embed"][-1]["w"].abs().sum()) > 0.0
    params = tbase.params_from_numpy(_stack(members), "cpu")
    lp = flow.log_prob(params, theta, x)
    key = jax.random.PRNGKey(4)
    n = 8
    keys = jax.random.split(key, 4)
    base = np.stack([np.asarray(jax.random.normal(k, (n, 2))) for k in keys])
    drawn = flow.sample_batch(params, x[:4], n,
                              base=np.broadcast_to(base, (2,) + base.shape))
    for k, member in enumerate(members):
        np.testing.assert_allclose(lp[k].numpy(),
                                   np.asarray(jflow.log_prob(member, theta, x)),
                                   atol=1e-4)
        np.testing.assert_allclose(
            drawn[k].numpy(), np.asarray(jflow.sample_batch(member, key,
                                                            x[:4], n)),
            atol=1e-4)
    leaf = params["embed"][0]["w"].requires_grad_(True)
    flow.log_prob(params, theta, x).sum().backward()
    assert leaf.grad is not None and float(leaf.grad.abs().sum()) > 0.0
