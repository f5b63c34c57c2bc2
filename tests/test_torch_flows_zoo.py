"""Port parity, the flow zoo: every registry name of
`synference_tpu/flows/base.py` against the port's `flows/` on the same numpy
inputs and the same JAX weights (two members, stacked, through
`params_from_numpy`).

Small sizes: θ dim 3, context 4, hidden 8, two transforms, CNF `num_steps` 4,
the zero last layers perturbed so that no flow is the identity.

Tolerances (absolute, float32):
- `log_prob` of every family 1e-4;
- `sample` with JAX's base draws passed in (normals, the "ncsf" box
  uniforms, the "mdn"/"gaussian" component uniforms) 1e-4, the families that
  invert by bisection too (both packages run the same 50 halvings of
  [-512, 512] on float32 transformers whose last bits differ; measured
  here: naf 5.2e-6, unaf 3.1e-5, sospf 2.9e-6; the closed-form inverses
  ≤ 6.7e-6), except "gf": 1e-3 (measured 5.2e-4). GF's probit of a mixture
  CDF u near 1 has slope up to 2e5, and the port takes it from 1 − u summed
  on its own where the JAX package subtracts u from 1, so one float32 ulp
  of u moves JAX's sample; the port's sample lies closer to the same
  computation in float64 than JAX's does (checked);
- the CNF's gradient against `jax.grad` 1e-4 relative on each leaf's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synference_tpu.flows import base as jbase
from synference_tpu.flows.made import made_masks as j_made_masks
from synference_tpu_torch.flows import base as tbase
from synference_tpu_torch.flows.made import made_masks

DIM, CTX, N = 3, 4, 32
ZOO = ["maf", "made", "nsf", "realnvp", "affine_coupling", "nice", "mdn",
       "gaussian", "ncsf", "naf", "unaf", "sospf", "gf", "cnf"]
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(model):
    cfg = {"hidden_features": 8}
    if model not in ("mdn", "gaussian", "made", "cnf"):
        cfg["num_transforms"] = 2
    if model == "cnf":
        cfg["num_steps"] = 4
    if model == "mdn":
        cfg["num_components"] = 3
    return cfg


def _data(seed=1):
    rng = np.random.default_rng(seed)
    theta = rng.normal(0, 2, (N, DIM)).astype(np.float32)
    x = rng.normal(1, 3, (N, CTX)).astype(np.float32)
    return theta, x


def _jax_members(model, theta, x, n_members=2, scale=0.1):
    """Stacked JAX parameters of `n_members` perturbed inits (numpy)."""
    flow = jbase.build_flow(model, DIM, CTX, **_cfg(model))
    trees = []
    for m in range(n_members):
        key = jax.random.PRNGKey(10 + m)
        p = flow.init(key, theta, x)
        leaves, treedef = jax.tree_util.tree_flatten(p)
        rng = np.random.default_rng(100 + m)
        leaves = [np.asarray(a) + (scale * rng.standard_normal(np.shape(a))
                                   ).astype(np.float32) for a in leaves]
        p = jax.tree_util.tree_unflatten(treedef, leaves)
        for k in ("theta_std", "x_std"):
            p[k] = np.abs(p[k]) + 0.5
        trees.append(p)
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)
    return flow, trees, stacked


def _port(model):
    return tbase.build_flow(model, DIM, CTX, device="cpu", **_cfg(model))


def _jax_base(model, flow, params, key, x0, n):
    """The base draws JAX's `sample` takes from `key`, in the port's layout."""
    cfg = _cfg(model)
    if model == "ncsf":
        tb = 5.0
        return np.asarray(jax.random.uniform(key, (n, DIM), minval=-tb,
                                             maxval=tb))
    if model in ("mdn", "gaussian"):
        k1, k2 = jax.random.split(key)
        nc = cfg.get("num_components", 1)
        u = jax.random.uniform(k1, (n, nc), minval=jnp.finfo(jnp.float32).tiny,
                               maxval=1.0)
        eps = jax.random.normal(k2, (n, DIM))
        return np.concatenate([np.asarray(eps), np.asarray(u)], axis=1)
    return np.asarray(jax.random.normal(key, (n, DIM)))


def test_made_masks_bitwise():
    for dim, hidden, n_out in ((1, (4,), 2), (3, (8, 8), 2), (6, (5, 7), 25)):
        for a, b in zip(made_masks(dim, hidden, n_out),
                        j_made_masks(dim, hidden, n_out)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", ZOO)
def test_log_prob_and_tree(model):
    """log_prob of both members (stacked and one at a time) to 1e-4; the
    port's own init has the JAX tree's keys and shapes; the spec is JAX's."""
    theta, x = _data()
    jflow, trees, stacked = _jax_members(model, theta, x)
    flow = _port(model)
    assert flow.spec() == jflow.spec()
    params = tbase.params_from_numpy(stacked, "cpu")
    with torch.no_grad():
        lp = flow.log_prob(params, theta, x).numpy()
    assert lp.shape == (2, N)
    for m, tree in enumerate(trees):
        ref = np.asarray(jflow.log_prob(tree, theta, x))
        assert np.isfinite(ref).all()
        np.testing.assert_allclose(lp[m], ref, rtol=0, atol=TOL)
        with torch.no_grad():
            one = flow.log_prob(tbase.params_from_numpy(tree, "cpu"), theta,
                                x).numpy()
        np.testing.assert_allclose(one, ref, rtol=0, atol=TOL)
    ref_flat = jbase.flatten_params(jax.tree_util.tree_map(
        jnp.asarray, stacked))
    own = flow.init(torch.Generator().manual_seed(0), theta, x, n_members=2)
    assert ({k: v.shape for k, v in tbase.flatten_params(own).items()}
            == {k: v.shape for k, v in ref_flat.items()})
    back = tbase.params_to_numpy(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, stacked)


@pytest.mark.parametrize("model", ZOO)
def test_sample_from_jax_draws(model):
    """`sample` of each member from the base draws JAX takes from its key,
    to 1e-4."""
    theta, x = _data(2)
    jflow, trees, stacked = _jax_members(model, theta, x)
    flow = _port(model)
    n = 16
    x0 = x[3]
    for m, tree in enumerate(trees):
        key = jax.random.PRNGKey(5 + m)
        ref = np.asarray(jflow.sample(tree, key, x0, n))
        base = _jax_base(model, jflow, tree, key, x0, n)
        with torch.no_grad():
            got = flow.sample(tbase.params_from_numpy(tree, "cpu"), x0, n,
                              base=base).numpy()
        assert got.shape == (n, DIM) and np.isfinite(ref).all()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-3 if model == "gf" else TOL)
        if model == "gf":  # the port is the closer one to float64
            p64 = tbase.tree_map(lambda a: a.to(torch.float64)[None],
                                 tbase.params_from_numpy(tree, "cpu"))
            ctx = ((torch.as_tensor(x0, dtype=torch.float64)
                    - p64["x_mean"][0]) / p64["x_std"][0])
            with torch.no_grad():
                z64 = flow._net.inverse(
                    p64["flow"], torch.as_tensor(base, dtype=torch.float64)[
                        None], ctx.expand(1, n, -1))[0]
            exact = (z64 * p64["theta_std"][0] + p64["theta_mean"][0]).numpy()
            assert (np.abs(got - exact).max()
                    <= np.abs(ref - exact).max() + 1e-6)


@pytest.mark.parametrize("model", ["maf", "nsf", "realnvp", "nice", "ncsf",
                                   "naf", "sospf", "gf", "cnf"])
def test_inverse_then_forward(model):
    """Base draws -> θ -> base again, on the port alone in float64 (the
    algorithm, not float32 conditioning): 1e-4; the CNF's reverse RK4 is the
    forward one's inverse only to its O(dt⁴) error: 1e-3 at 4 steps."""
    theta, x = _data(3)
    _, _, stacked = _jax_members(model, theta, x)
    flow = _port(model)
    params = tbase.params_from_numpy(stacked, "cpu")
    dtype = torch.float64
    net_params = tbase.tree_map(lambda a: a.to(dtype), params["flow"])
    g = torch.Generator().manual_seed(0)
    base = flow._net.draw_base(g, (2, 64)).to(dtype)
    ctx = torch.as_tensor(x[:1], dtype=dtype).expand(2, 64, CTX)
    with torch.no_grad():
        th = flow._net.inverse(net_params, base, ctx)
        back, _ = flow._net.forward(net_params, th, ctx)
    if model == "ncsf":  # the torus: compare modulo the period
        d = torch.remainder(back - base + 5.0, 10.0) - 5.0
    else:
        d = back - base
    assert float(d.abs().max()) < (1e-3 if model == "cnf" else TOL)


def test_cnf_gradient_matches_jax_grad():
    """d(−mean log q)/dparams through the exact RK4 trace, against
    `jax.grad` of the JAX log-prob: 1e-4 relative on each leaf's norm."""
    theta, x = _data(4)
    jflow, trees, _ = _jax_members("cnf", theta, x, n_members=1)
    tree = trees[0]
    ref = jax.grad(lambda p: -jflow.log_prob(p, theta, x).mean())(
        jax.tree_util.tree_map(jnp.asarray, tree))
    flow = _port("cnf")
    params = tbase.params_from_numpy(tree, "cpu")
    leaves = tbase.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = -flow.log_prob(params, theta, x).mean()
    grads = torch.autograd.grad(loss, leaves)
    ref_leaves = [np.asarray(a) for _, a in sorted(
        jbase.flatten_params(ref).items())]
    got = dict(zip([k for k, _ in tbase._leaves_with_path(params)], grads))
    for (k, r) in sorted(jbase.flatten_params(ref).items()):
        g = got[k].numpy()
        scale = max(np.linalg.norm(r), 1e-6)
        assert np.linalg.norm(g - r) / scale < 1e-4, k
    assert len(ref_leaves) == len(grads)


def test_registry_defaults_and_errors():
    """made → one block, gaussian → one component, nice → clamp 0; an
    unknown name raises; "mdn" has no base-space map."""
    assert len(tbase.build_flow("made", 3, 2, device="cpu").init(
        torch.Generator().manual_seed(0))["flow"]["blocks"]) == 1
    g = tbase.build_flow("gaussian", 3, 2, device="cpu")
    assert g._net.nc == 1
    assert tbase.build_flow("nice", 3, 2, device="cpu")._net.clamp == 0.0
    with pytest.raises(ValueError, match="unknown flow model"):
        tbase.build_flow("zuko", 3, 2, device="cpu")
    mdn = tbase.build_flow("mdn", 3, 2, device="cpu", hidden_features=4)
    p = mdn.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no base-space map"):
        mdn.to_base(p, np.zeros((2, 3)), np.zeros((2, 2)))
