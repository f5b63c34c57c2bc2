"""Port parity, training: `train.py` against optax and the JAX trainer.

- One optimiser step (two in a row, so that the moments and the bias
  correction are exercised) from the same parameters, minibatches, per-member
  learning rates, clip and weight decay against `optax.chain(
  clip_by_global_norm, adamw)`: updated parameters to 1e-6 absolute, with a
  clip that bites and one that does not. Each member's norm is its own.
  optax is given the port's gradient of each minibatch, which is first held
  to `jax.grad` on the same minibatch (1e-4 relative on each member's global
  norm): Adam divides by the gradient's magnitude, so where a gradient
  element is near 1e-8 a last-bit difference between the packages' gradients
  would move the update by a share of the learning rate.
- The grouped split, early stopping, best-parameter tracking, per-member
  shuffles, checkpoint and resume are checked on the port alone.
- Training as a whole is compared by distribution: the final validation loss
  on a conditional-Gaussian toy over 3 seeds lies inside the band of the JAX
  trainer's 3 seeds widened by their spread and 0.1 nat (the random streams
  of the two packages differ, so nothing is bitwise).

Not carried over from the JAX trainer, each a TPU dispatch workaround:
`whole_run` (the run as one device program), `epochs_per_dispatch`,
`_WHOLE_RUN_CACHE` and `_canon_spec` (the cache of traced programs), the
learning rate injected into the optimiser state, `init_members` under jit,
and the unvmapped `n_nets == 1` branch: in the port K = 1 is the same code
as K = 8, and a step is eager. The port reads one small tensor back per
epoch and nothing inside an epoch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synference_tpu.flows import base as jbase
from synference_tpu.train import TrainConfig as JTrainConfig
from synference_tpu.train import train_ensemble as jtrain_ensemble
from synference_tpu_torch.flows import base as tbase
from synference_tpu_torch.train import (TrainConfig, _EnsembleState,
                                        _split_data, train_ensemble,
                                        train_npe)

CFG = dict(hidden_features=16, num_transforms=3, num_bins=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_data(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    theta = np.stack(
        [x[:, 0] + 0.1 * rng.standard_normal(n),
         x[:, 1] - x[:, 2] + 0.1 * rng.standard_normal(n)], axis=1
    ).astype(np.float32)
    return theta, x


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _flow():
    return tbase.build_flow("nsf", 2, 3, device="cpu", **CFG)


@pytest.mark.parametrize("clip,bites", [(0.05, True), (1.0e3, False)])
def test_optimizer_step_matches_optax(clip, bites):
    k, bs, wd = 3, 64, 0.01
    lrs = np.array([1e-3, 3e-3, 7e-4], np.float32)
    jflow = jbase.build_flow("nsf", 2, 3, **CFG)
    flow = _flow()
    theta, x = _toy_data(600)
    rng = np.random.default_rng(1)
    members = []
    for s in range(k):
        p = jax.tree_util.tree_map(
            np.asarray, jflow.init(jax.random.PRNGKey(s), theta, x))
        for block in p["flow"]["blocks"]:  # leave the identity
            w = block[-1]["w"]
            block[-1]["w"] = (0.05 * rng.standard_normal(w.shape)
                              ).astype(np.float32)
        members.append(p)
    rows = rng.integers(0, len(theta), (2, k, bs))

    def jloss(p, tb, xb):
        return -jflow.log_prob(p, tb, xb).mean()

    stacked = tbase.params_from_numpy(
        jax.tree_util.tree_map(lambda *a: np.stack(a), *members), "cpu")
    state = _EnsembleState(stacked, torch.as_tensor(lrs),
                           TrainConfig(clip_max_norm=clip, weight_decay=wd))

    def loss_fn(p, tb, xb):
        return -flow.log_prob(p, tb, xb).mean(dim=-1)

    txs = [optax.chain(optax.clip_by_global_norm(clip),
                       optax.adamw(float(lrs[m]), weight_decay=wd))
           for m in range(k)]
    expected = [jax.tree_util.tree_map(jnp.asarray, p) for p in members]
    opts = [tx.init(p) for tx, p in zip(txs, expected)]
    norms = []
    for step in range(2):
        tb = torch.as_tensor(theta[rows[step]])
        xb = torch.as_tensor(x[rows[step]])
        leaves = tbase.tree_leaves(state.params)
        grads = tbase.params_to_numpy(tbase.tree_unflatten(
            state.params, torch.autograd.grad(
                loss_fn(state.params, tb, xb).sum(), leaves)))
        for m in range(k):
            g = jax.tree_util.tree_map(lambda a: jnp.asarray(a[m]), grads)
            ref_g = jax.grad(jloss)(expected[m], theta[rows[step, m]],
                                    x[rows[step, m]])
            norm = float(optax.global_norm(ref_g))
            norms.append(norm)
            diff = jax.tree_util.tree_map(lambda a, b: a - b, g, ref_g)
            assert float(optax.global_norm(diff)) <= 1e-4 * norm
            updates, opts[m] = txs[m].update(g, opts[m], expected[m])
            expected[m] = optax.apply_updates(expected[m], updates)
        state.train_step(loss_fn, tb, xb)
    assert all((n > clip) == bites for n in norms), norms
    assert state.step == 2

    got = tbase.params_to_numpy(state.params)
    for m in range(k):
        ref = jbase.flatten_params(expected[m])
        out = tbase.flatten_params(tbase.params_from_numpy(
            jax.tree_util.tree_map(lambda a: a[m], got), "cpu"))
        for key in ref:
            np.testing.assert_allclose(out[key], ref[key], atol=1e-6,
                                       err_msg=f"member {m} {key}")
    # a step moved every member
    assert all(np.abs(got["flow"]["blocks"][0][0]["w"][m]
                      - members[m]["flow"]["blocks"][0][0]["w"]).max() > 0
               for m in range(k))


def test_grouped_split_keeps_groups_on_one_side():
    n = 900
    ids = np.arange(n, dtype=np.float32)
    groups = np.arange(n) // 3  # three scatter copies per galaxy
    theta = torch.as_tensor(np.stack([ids, ids], axis=1))
    x = torch.as_tensor(ids[:, None])
    cfg = TrainConfig(validation_fraction=0.2)
    (t_tr, x_tr), (t_va, x_va) = _split_data(theta, x, cfg, _gen(), groups)
    g_tr = set(groups[t_tr[:, 0].long().numpy()])
    g_va = set(groups[t_va[:, 0].long().numpy()])
    assert not g_tr & g_va
    assert len(g_va) == 60 and len(g_tr) == 240
    assert torch.equal(t_tr[:, 0], x_tr[:, 0])
    # another seed, another split; no groups: a row-level split
    (_, _), (t_va2, _) = _split_data(theta, x, cfg, _gen(1), groups)
    assert set(t_va2[:, 0].tolist()) != set(t_va[:, 0].tolist())
    (t_tr, _), (t_va, _) = _split_data(theta, x, cfg, _gen())
    assert t_va.shape[0] == 180 and t_tr.shape[0] == 720
    assert not set(t_tr[:, 0].tolist()) & set(t_va[:, 0].tolist())


def test_training_improves_and_tracks_best():
    theta, x = _toy_data(1200)
    flow = _flow()
    cfg = TrainConfig(max_epochs=12, stop_after_epochs=12, batch_size=64,
                      learning_rate=2e-2)
    res = train_ensemble(flow, theta, x, _gen(3), cfg, n_nets=3)
    assert res.val_losses.shape == res.train_losses.shape == (12, 3)
    assert np.isfinite(res.val_losses).all()
    assert (res.val_losses[-1] < res.val_losses[0]).all()
    assert res.n_members == 3
    assert res.history["steps_per_epoch"] == 960 // 64
    # each member keeps the parameters of its own best epoch
    best = res.val_losses.min(axis=0)
    np.testing.assert_allclose(res.history["best_val"], best, rtol=1e-6)
    assert (res.val_losses.argmin(axis=0) < 11).any()  # not all at the end
    assert res.best_epoch == int(np.argmin(res.val_losses.mean(axis=1)))
    # the same generator seed gives the same split: the returned parameters
    # reproduce the best validation loss
    (_, _), (t_va, x_va) = _split_data(torch.as_tensor(theta),
                                       torch.as_tensor(x), cfg, _gen(3))
    with torch.no_grad():
        again = -flow.log_prob(res.params, t_va, x_va).mean(dim=-1)
    np.testing.assert_allclose(again.numpy(), best, atol=1e-5)
    # members differ
    w = res.params["flow"]["blocks"][0][0]["w"]
    assert not torch.allclose(w[0], w[1])


def test_early_stopping_and_train_npe():
    theta, x = _toy_data(400)
    res = train_npe(_flow(), theta, x, _gen(), TrainConfig(
        max_epochs=500, stop_after_epochs=3, batch_size=128,
        learning_rate=5e-2))
    assert 3 < len(res.val_losses) < 500
    assert res.val_losses.ndim == 1 and res.n_members == 1
    assert res.params["theta_mean"].shape == (2,)  # no member axis
    # the last `patience` epochs did not improve on the best
    assert res.val_losses[-3:].min() >= res.val_losses.min()


def test_members_get_their_own_shuffles():
    theta, x = _toy_data(640)
    theta[:, 0] = np.arange(640)  # row ids
    flow = _flow()
    seen = []

    def loss_fn(p, tb, xb):
        if tb.ndim == 3:  # a training minibatch (validation is 2-D)
            seen.append(tb[..., 0].detach().clone())
        return -flow.log_prob(p, tb, xb).mean(dim=-1)

    train_ensemble(flow, theta, x, _gen(), TrainConfig(
        max_epochs=2, batch_size=128, validation_fraction=0.2), n_nets=3,
        loss_fn=loss_fn)
    steps = 512 // 128
    assert len(seen) == 2 * steps and seen[0].shape == (3, 128)
    first = torch.cat(seen[:steps], dim=1)  # (3, 512): epoch 1
    second = torch.cat(seen[steps:], dim=1)
    for m in range(3):  # a permutation: every training row exactly once
        assert len(set(first[m].tolist())) == 512
    assert not torch.equal(first[0], first[1])
    assert not torch.equal(first[1], first[2])
    assert not torch.equal(first[0], second[0])  # reshuffled every epoch
    assert set(first[0].tolist()) == set(first[1].tolist())


def test_epoch_callback_prunes_and_member_learning_rates():
    theta, x = _toy_data(400)
    calls = []

    def callback(epoch, tr, va):
        calls.append((epoch, tr.shape, va.shape))
        return epoch >= 2

    res = train_ensemble(_flow(), theta, x, _gen(), TrainConfig(
        max_epochs=10, batch_size=128), n_nets=2, epoch_callback=callback,
        member_learning_rates=[0.0, 1e-2])
    assert res.history["pruned"] and len(res.val_losses) == 3
    assert calls == [(0, (2,), (2,)), (1, (2,), (2,)), (2, (2,), (2,))]
    assert res.history["member_learning_rates"] == [0.0, 1e-2]
    # the member with a zero learning rate did not move
    assert res.val_losses[0, 0] == res.val_losses[2, 0]
    assert res.val_losses[2, 1] < res.val_losses[0, 1]
    with pytest.raises(ValueError, match="member_learning_rates"):
        train_ensemble(_flow(), theta, x, _gen(), TrainConfig(max_epochs=1),
                       n_nets=2, member_learning_rates=[1e-3])


def test_checkpoint_resume_continues_to_the_same_result(tmp_path):
    theta, x = _toy_data(400)
    kw = dict(max_epochs=6, stop_after_epochs=50, batch_size=128,
              learning_rate=5e-3)
    plain = train_ensemble(_flow(), theta, x, _gen(7), TrainConfig(**kw),
                           n_nets=2)
    ckpt = str(tmp_path / "ck.pkl")
    cfg = TrainConfig(checkpoint_path=ckpt, checkpoint_every=2, **kw)

    def crash(epoch, tr, va):
        if epoch >= 3:
            raise RuntimeError("simulated worker death")
        return False

    with pytest.raises(RuntimeError, match="simulated"):
        train_ensemble(_flow(), theta, x, _gen(7), cfg, n_nets=2,
                       resume=False, epoch_callback=crash)
    assert os.path.exists(ckpt)  # written after epoch 1
    resumed = train_ensemble(_flow(), theta, x, _gen(7), cfg, n_nets=2,
                             resume=True)
    assert not os.path.exists(ckpt)  # dropped on success
    assert len(resumed.val_losses) == 6  # 2 from the checkpoint + 4
    np.testing.assert_allclose(resumed.val_losses, plain.val_losses,
                               rtol=1e-6)
    np.testing.assert_allclose(resumed.train_losses, plain.train_losses,
                               rtol=1e-6)
    for a, b in zip(tbase.tree_leaves(resumed.params),
                    tbase.tree_leaves(plain.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    # resume=False ignores a checkpoint that is there
    with pytest.raises(RuntimeError, match="simulated"):
        train_ensemble(_flow(), theta, x, _gen(7), cfg, n_nets=2,
                       resume=False, epoch_callback=crash)
    fresh = train_ensemble(_flow(), theta, x, _gen(7), cfg, n_nets=2,
                           resume=False)
    assert len(fresh.val_losses) == 6


def test_unported_options_name_their_roadmap_item(tmp_path):
    """The "orbax" checkpoint backend, refused before `parallel/` was
    ported, now keeps a directory with this rank's `torch.save` file while
    training runs and removes it on success; `live_plot`, refused before
    `runtime.py` was ported, draws one line per epoch to a non-terminal
    stdout."""
    import contextlib
    import io

    theta, x = _toy_data(200)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_ensemble(_flow(), theta, x, _gen(),
                       TrainConfig(max_epochs=1, live_plot=True))
    assert buf.getvalue().startswith("epoch    0  train ")
    ck = tmp_path / "ck"
    seen = []

    def look(epoch, tr, va):
        seen.append(sorted(p.name for p in ck.iterdir())
                    if ck.is_dir() else None)

    train_ensemble(_flow(), theta, x, _gen(), TrainConfig(
        max_epochs=2, checkpoint_every=1, checkpoint_backend="orbax",
        checkpoint_path=str(ck)), epoch_callback=look)
    assert seen == [None, ["rank00000-of-00001.pt"]]
    assert not ck.exists()


def test_final_validation_loss_in_the_jax_trainers_band():
    """Conditional-Gaussian toy (θ | x normal with σ = 0.1 per dimension:
    the optimum is −1.77 nat). 3 seeds per package, 15 epochs of NSF 16 × 3.
    Band: [min − spread − 0.1, max + spread + 0.1] of the JAX trainer's
    best validation losses, spread = max − min."""
    theta, x = _toy_data(2000)
    kw = dict(max_epochs=15, stop_after_epochs=15, batch_size=128,
              learning_rate=3e-3)
    jflow = jbase.build_flow("nsf", 2, 3, **CFG)
    ref = [float(np.min(jtrain_ensemble(
        jflow, theta, x, jax.random.PRNGKey(s), JTrainConfig(**kw),
        n_nets=1).val_losses)) for s in range(3)]
    got = [float(np.min(train_ensemble(
        _flow(), theta, x, _gen(s), TrainConfig(**kw), n_nets=1).val_losses))
        for s in range(3)]
    spread = max(ref) - min(ref)
    lo, hi = min(ref) - spread - 0.1, max(ref) + spread + 0.1
    assert all(lo <= v <= hi for v in got), (got, ref)
    assert all(v < -1.0 for v in got + ref), (got, ref)  # both learned
