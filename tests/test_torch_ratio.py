"""Port parity, `ratio.py`: the NRE classifier of both packages on the same
numpy inputs and the same JAX weights (through `params_from_numpy`).

Small sizes: θ dim 2, x dim 3, hidden 16, 2 members.

Tolerances (absolute, float32): logits 1e-5 for the "mlp", "resnet" and
"linear" nets, stacked and one member at a time; the NRE loss 1e-5, with
the marginal pairs rolled along the batch axis (dim −2 of (K, B, P)), not
the member axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synference_tpu import ratio as jratio
from synference_tpu_torch import ratio as tratio
from synference_tpu_torch.flows.base import params_from_numpy, tree_map
from synference_tpu_torch.train import TrainConfig, train_ensemble

NETS = ("mlp", "resnet", "linear")
TOL = 1e-5


def _data(n=48, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.normal(0, 1, (n, 2)).astype(np.float32)
    x = (theta @ np.array([[1.0, 0.4, -0.3], [0.2, 1.0, 0.5]], np.float32)
         + 0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    return theta, x


def _members(net, theta, x):
    est = jratio.build_ratio_estimator(2, 3, net=net, hidden_features=16)
    trees = [jax.tree_util.tree_map(np.asarray,
                                    est.init(jax.random.PRNGKey(k), theta, x))
             for k in (0, 1)]
    return est, trees, jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)


@pytest.mark.parametrize("net", NETS)
def test_logits_and_loss(net):
    """Logits (stacked (K, B), single (B,)) and the loss against JAX, 1e-5;
    the spec is JAX's."""
    theta, x = _data()
    jest, trees, stacked = _members(net, theta, x)
    est = tratio.build_ratio_estimator(2, 3, net=net, hidden_features=16,
                                       device="cpu")
    assert est.spec() == jest.spec()
    params = params_from_numpy(stacked, "cpu")
    with torch.no_grad():
        logits = est.logit(params, theta, x).numpy()
    assert logits.shape == (2, len(theta))
    jloss = jratio.nre_loss(jest)
    loss = tratio.nre_loss(est)
    for m, tree in enumerate(trees):
        ref = np.asarray(jest.logit(tree, theta, x))
        np.testing.assert_allclose(logits[m], ref, rtol=0, atol=TOL)
        with torch.no_grad():
            one = est.logit(params_from_numpy(tree, "cpu"), theta, x).numpy()
        np.testing.assert_allclose(one, ref, rtol=0, atol=TOL)
        ref_loss = float(jloss(jax.tree_util.tree_map(jnp.asarray, tree),
                               jnp.asarray(theta), jnp.asarray(x)))
        with torch.no_grad():
            # one batch per member: the roll runs along the batch axis
            per_member = loss(params, torch.as_tensor(theta).expand(2, -1, -1),
                              torch.as_tensor(x).expand(2, -1, -1)).numpy()
        np.testing.assert_allclose(per_member[m], ref_loss, rtol=0, atol=TOL)
    with torch.no_grad():
        shared = loss(params, theta, x).numpy()  # (B, ·) batches, validation
    np.testing.assert_allclose(shared, per_member, rtol=0, atol=TOL)


def test_own_init_tree_and_spec_round_trip():
    theta, x = _data()
    jest, _, stacked = _members("resnet", theta, x)
    est = tratio.build_ratio_estimator(2, 3, net="resnet", hidden_features=16,
                                       device="cpu")
    own = est.init(torch.Generator().manual_seed(0), theta, x, n_members=2)
    shapes = jax.tree_util.tree_map(np.shape, stacked)
    assert tree_map(lambda a: tuple(a.shape), own) == shapes
    single = est.init(torch.Generator().manual_seed(0), theta, x)
    assert single["theta_mean"].shape == (2,)
    again = tratio.RatioEstimator.from_spec(est.spec(), "cpu")
    assert again.spec() == est.spec()
    assert tratio.build_ratio_estimator(2, 3, net="linear",
                                        device="cpu").num_layers == 0
    with pytest.raises(ValueError, match="unknown NRE net"):
        tratio.build_ratio_estimator(2, 3, net="transformer", device="cpu")


@pytest.mark.parametrize("net", NETS)
def test_trains_under_train_ensemble(net):
    """Every net learns under `train_ensemble(loss_fn=nre_loss)` with two
    members (the JAX test's check: the loss falls below its start); the
    nets with hidden layers also beat chance, log 2 (a linear logit of
    [θ, x] has no θ·x term to learn the ratio with)."""
    theta, x = _data(512, seed=6)
    est = tratio.build_ratio_estimator(2, 3, net=net, hidden_features=16,
                                       device="cpu")
    res = train_ensemble(est, theta, x,
                         generator=torch.Generator().manual_seed(0),
                         config=TrainConfig(max_epochs=3, batch_size=64,
                                            learning_rate=1e-2),
                         n_nets=2, loss_fn=tratio.nre_loss(est))
    assert res.val_losses.shape == (3, 2)
    assert (res.val_losses[-1] < res.val_losses[0]).all()
    if net != "linear":
        assert (res.val_losses.min(axis=0) < np.log(2.0)).all()
