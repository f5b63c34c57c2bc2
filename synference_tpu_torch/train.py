"""NPE training: batched ensembles, early stopping, checkpoints.

Counterpart of `synference_tpu/train.py`. The whole dataset lives on the
flow's device; the members of an ensemble are one set of batched weights, and
every member draws its own permutation of the training rows per epoch. A step
is: minibatch loss −mean log q(θ|x) per member, its gradient, a global-norm
clip per member, AdamW (the arithmetic of `optax.chain(clip_by_global_norm,
adamw)`, with one learning rate per member). After each epoch comes the
validation loss on the whole validation set and the tracking of each member's
best parameters, all on the device.

All parameters of the ensemble live in one `(K, P)` buffer of which the
tree's leaves are views, so the optimiser and the best-parameter tracking
are a handful of operations on that buffer whatever the number of leaves.

Nothing inside an epoch reads a value back to the host: on a CUDA device the
epoch runs under `torch.cuda.set_sync_debug_mode("error")`, so a
synchronising call there (also one inside a caller's `loss_fn`) raises. One
small tensor with the epoch's losses and patience counters comes back per
epoch; the stop test and `epoch_callback` read it.

`TrainConfig(live_plot=True)` draws `runtime.TerminalLossPlot` to stdout
once per epoch. Checkpoints are one pickle file (backend "pickle") or, with
backend "orbax" (the JAX package's name; orbax itself imports JAX and is
not used), a directory of per-rank `torch.save` files that is replaced
atomically: every rank of a running process group writes its own file.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from .flows.base import tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainConfig", "TrainResult", "train_npe", "train_ensemble",
           "save_checkpoint", "load_checkpoint"]

_B1, _B2, _EPS = 0.9, 0.999, 1.0e-8  # optax.adamw defaults
_VAL_CHUNK = 65536  # validation rows per forward pass


@dataclass
class TrainConfig:
    batch_size: int = 256
    learning_rate: float = 1.0e-4
    max_epochs: int = 500
    stop_after_epochs: int = 20  # early-stop patience on val loss
    validation_fraction: float = 0.2
    clip_max_norm: float = 5.0
    weight_decay: float = 0.0
    checkpoint_path: str | None = None
    checkpoint_every: int = 10
    checkpoint_backend: str = "pickle"
    live_plot: bool = False


@dataclass
class TrainResult:
    params: dict  # best-val parameters, stacked over members
    train_losses: np.ndarray  # (epochs, n_nets)
    val_losses: np.ndarray
    best_epoch: int
    n_members: int = 1
    history: dict = field(default_factory=dict)


def _split_data(theta, x, cfg, generator, groups=None):
    """Train/val split; with `groups` (per-row source-galaxy ids) all copies
    of a galaxy land on one side: scatter-duplicated rows would otherwise
    leak θ across the split."""
    n = theta.shape[0]
    dev = theta.device
    if groups is None:
        perm = torch.randperm(n, generator=generator, device=dev)
        n_val = max(int(n * cfg.validation_fraction), 1)
        val_idx, train_idx = perm[:n_val], perm[n_val:]
    else:
        groups = np.asarray(groups)
        uniq = np.unique(groups)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=dev))
        perm_g = np.random.default_rng(seed).permutation(len(uniq))
        n_val_g = max(int(len(uniq) * cfg.validation_fraction), 1)
        is_val = np.isin(groups, uniq[perm_g[:n_val_g]])
        val_idx = torch.as_tensor(np.where(is_val)[0], device=dev)
        train_idx = torch.as_tensor(np.where(~is_val)[0], device=dev)
    return (theta[train_idx], x[train_idx]), (theta[val_idx], x[val_idx])


def _pack(params):
    """Stacked parameter tree -> ((K, P) buffer, unpack). `unpack(buffer)`
    gives a tree of the same structure whose leaves are views of the
    buffer."""
    leaves = tree_leaves(params)
    k = leaves[0].shape[0]
    shapes = [leaf.shape for leaf in leaves]
    sizes = [leaf[0].numel() for leaf in leaves]
    flat = torch.cat([leaf.reshape(k, -1) for leaf in leaves], dim=1)

    def unpack(buffer):
        return tree_unflatten(params, [
            chunk.view(shape)
            for chunk, shape in zip(buffer.split(sizes, dim=1), shapes)])

    return flat, unpack


def _optimizer_step(flat, grad, m, v, step: int, lrs, clip_max_norm: float,
                    weight_decay: float) -> None:
    """One step of `optax.chain(clip_by_global_norm(c), adamw(lr, wd))` on
    the (K, P) buffers, in place; `step` counts from 1 and `lrs` is (K,).
    Each member's gradient norm is its own."""
    if clip_max_norm and clip_max_norm > 0:
        norm = grad.square().sum(dim=1, keepdim=True).sqrt()
        grad = torch.where(norm < clip_max_norm, grad,
                           grad / norm * clip_max_norm)
    m.mul_(_B1).add_(grad, alpha=1.0 - _B1)
    v.mul_(_B2).addcmul_(grad, grad, value=1.0 - _B2)
    update = (m / (1.0 - _B1 ** step)) / (
        (v / (1.0 - _B2 ** step)).sqrt_() + _EPS)
    if weight_decay:
        update.add_(flat, alpha=weight_decay)
    flat.sub_(lrs.unsqueeze(1) * update)


class _EnsembleState:
    """The parameters of K members and their optimiser state, on the
    device. `params` is the tree the loss reads: its leaves share the
    storage of the `(K, P)` buffer `flat` that the optimiser writes."""

    def __init__(self, stacked_params, lrs, cfg: TrainConfig):
        self.flat, self.unpack = _pack(stacked_params)
        self.m = torch.zeros_like(self.flat)
        self.v = torch.zeros_like(self.flat)
        self.step = 0
        self.lrs = lrs
        self.cfg = cfg
        self.params = self.unpack(self.flat)
        self._leaves = [leaf.requires_grad_()
                        for leaf in tree_leaves(self.params)]

    def train_step(self, loss_fn, theta_b, x_b):
        """Loss, gradient, clip and AdamW on one (K, B, ·) minibatch;
        returns the (K,) losses. Reads nothing back to the host."""
        k = self.flat.shape[0]
        loss = loss_fn(self.params, theta_b, x_b)
        grads = torch.autograd.grad(loss.sum(), self._leaves,
                                    allow_unused=True, materialize_grads=True)
        with torch.no_grad():
            grad = torch.cat([g.reshape(k, -1) for g in grads], dim=1)
            self.step += 1
            _optimizer_step(self.flat, grad, self.m, self.v, self.step,
                            self.lrs, self.cfg.clip_max_norm,
                            self.cfg.weight_decay)
        return loss.detach()


def _npe_loss(flow):
    """The NPE loss of `flow`: (stacked params, θ, x) -> (K,) values of
    −mean log q(θ|x)."""
    def loss_fn(p, tb, xb):
        return -flow.log_prob(p, tb, xb).mean(dim=-1)

    return loss_fn


def _new_state(flow, t_tr, x_tr, cfg: TrainConfig, n_nets: int,
               generator: torch.Generator,
               member_learning_rates=None) -> _EnsembleState:
    """Freshly initialised members of `flow` (standardised on the training
    rows) with their learning rates and optimiser state: what
    `train_ensemble` starts from, and what a profile of one step builds."""
    dev = torch.device(flow.device)
    if member_learning_rates is not None:
        lrs = torch.as_tensor(member_learning_rates, dtype=torch.float32,
                              device=dev)
        if lrs.shape != (n_nets,):
            raise ValueError(
                f"member_learning_rates must have shape ({n_nets},), "
                f"got {tuple(lrs.shape)}")
    else:
        lrs = torch.full((n_nets,), cfg.learning_rate, device=dev)
    return _EnsembleState(
        flow.init(generator, t_tr, x_tr, n_members=n_nets), lrs, cfg)


@contextlib.contextmanager
def _no_host_sync(device: torch.device):
    """On a CUDA device, make any call that waits for the device raise."""
    if device.type != "cuda":
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        # torch warns on every call that the mode is a prototype
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            torch.cuda.set_sync_debug_mode(previous)


def _validation_loss(loss_fn, params, t_va, x_va):
    """(K,) loss over the whole validation set, in row chunks."""
    n = t_va.shape[0]
    total = 0.0
    for i in range(0, n, _VAL_CHUNK):
        rows = min(_VAL_CHUNK, n - i)
        total = total + loss_fn(params, t_va[i:i + rows],
                                x_va[i:i + rows]) * (rows / n)
    return total


def train_npe(flow, theta, x, generator: torch.Generator | None = None,
              config: TrainConfig | None = None, resume: bool = True,
              groups=None) -> TrainResult:
    """Train a single NPE flow with the −E[log q(θ|x)] loss; the result
    comes without the member axis."""
    result = train_ensemble(flow, theta, x, generator=generator,
                            config=config, n_nets=1, resume=resume,
                            groups=groups)
    result.params = tree_map(lambda a: a[0], result.params)
    result.train_losses = result.train_losses[:, 0]
    result.val_losses = result.val_losses[:, 0]
    return result


def train_ensemble(flow, theta, x, generator: torch.Generator | None = None,
                   config: TrainConfig | None = None, n_nets: int = 1,
                   resume: bool = True, groups=None, loss_fn=None,
                   epoch_callback=None,
                   member_learning_rates=None) -> TrainResult:
    """Train n_nets flows at once on `flow.device`.

    Returns stacked parameters with a leading member axis; `val_losses` has
    shape (epochs, n_nets). Each member keeps the parameters of its best
    validation epoch; training stops when every member's patience is
    exhausted.

    Args:
        generator: source of the split, the initial weights and the
            shuffles, on the flow's device (seed 0 when None).
        loss_fn: optional (stacked params, θ batch, x batch) -> (K,) losses
            replacing the NPE loss; the batches are (K, B, ·) in a training
            step and (B, ·), shared by the members, in validation. `flow`
            then only needs `device` and `init(generator, θ, x, n_members)`.
        epoch_callback: optional (epoch, train_loss (n_nets,), val_loss
            (n_nets,)) -> bool called after every epoch; True aborts
            training, keeps the best parameters so far and sets
            `history["pruned"]`.
        member_learning_rates: optional (n_nets,) learning rates, one per
            member (overrides config.learning_rate).
    """
    cfg = config or TrainConfig()
    dev = torch.device(flow.device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if theta.ndim == 1:
        theta = theta[:, None]

    (t_tr, x_tr), (t_va, x_va) = _split_data(theta, x, cfg, generator, groups)
    n_train = t_tr.shape[0]
    bs = min(cfg.batch_size, n_train)
    steps_per_epoch = max(n_train // bs, 1)

    if loss_fn is None:
        loss_fn = _npe_loss(flow)
    state = _new_state(flow, t_tr, x_tr, cfg, n_nets, generator,
                       member_learning_rates)
    flat, params = state.flat, state.params
    best_flat = flat.clone()
    best_val = torch.full((n_nets,), torch.inf, device=dev)
    since_best = torch.zeros(n_nets, dtype=torch.int32, device=dev)
    train_hist, val_hist = [], []
    start_epoch = 0
    pruned = False
    live = None
    if cfg.live_plot:
        from .runtime import TerminalLossPlot

        live = TerminalLossPlot(label=f"npe x{n_nets}")

    ckpt = cfg.checkpoint_path
    backend = cfg.checkpoint_backend

    def checkpoint_state(epoch_done: int) -> dict:
        return {
            "flat": flat.cpu().numpy(), "m": state.m.cpu().numpy(),
            "v": state.v.cpu().numpy(), "step": state.step,
            "best_flat": best_flat.cpu().numpy(),
            "best_val": best_val.cpu().numpy(), "epoch": epoch_done,
            "epochs_since_best": since_best.cpu().numpy(),
            "train_hist": train_hist, "val_hist": val_hist,
            "generator_state": generator.get_state().numpy(),
        }

    if ckpt and resume and os.path.exists(ckpt):
        saved = load_checkpoint(ckpt, backend=backend)
        with torch.no_grad():
            for buf, key in ((flat, "flat"), (state.m, "m"), (state.v, "v"),
                             (best_flat, "best_flat"), (best_val, "best_val"),
                             (since_best, "epochs_since_best")):
                buf.copy_(torch.as_tensor(saved[key]))
        state.step = int(saved["step"])
        start_epoch = int(saved["epoch"]) + 1
        train_hist = [np.asarray(r) for r in saved["train_hist"]]
        val_hist = [np.asarray(r) for r in saved["val_hist"]]
        generator.set_state(torch.as_tensor(saved["generator_state"]))

    for epoch in range(start_epoch, cfg.max_epochs):
        with _no_host_sync(dev):
            order = torch.rand((n_nets, n_train), generator=generator,
                               device=dev).argsort(dim=1)
            order = order[:, :steps_per_epoch * bs].reshape(
                n_nets, steps_per_epoch, bs)
            train_loss = torch.zeros(n_nets, device=dev)
            for s in range(steps_per_epoch):
                rows = order[:, s]
                train_loss += state.train_step(loss_fn, t_tr[rows],
                                               x_tr[rows])
            with torch.no_grad():
                val_loss = _validation_loss(loss_fn, params, t_va, x_va)
                improved = val_loss < best_val
                best_flat = torch.where(improved.unsqueeze(1), flat,
                                        best_flat)
                best_val = torch.where(improved, val_loss, best_val)
                since_best = torch.where(improved, 0, since_best + 1)
                report = torch.stack([train_loss / steps_per_epoch, val_loss,
                                      since_best.to(torch.float32)])
        # the epoch's one readback
        tr_np, va_np, patience = report.cpu().numpy()
        train_hist.append(tr_np)
        val_hist.append(va_np)
        if live is not None:
            live.update(epoch, tr_np, va_np)
        if epoch_callback is not None and bool(
                epoch_callback(epoch, tr_np, va_np)):
            pruned = True
            break
        if ckpt and (epoch + 1) % cfg.checkpoint_every == 0:
            save_checkpoint(ckpt, checkpoint_state(epoch), backend=backend)
        if bool((patience >= cfg.stop_after_epochs).all()):
            break

    if ckpt and os.path.exists(ckpt):  # success: drop the checkpoint
        if backend == "orbax" and os.path.isdir(ckpt):
            _drop_checkpoint_dir(ckpt)
        else:
            os.remove(ckpt)

    val_arr = np.stack(val_hist) if val_hist else np.zeros((0, n_nets))
    tr_arr = np.stack(train_hist) if train_hist else np.zeros((0, n_nets))
    return TrainResult(
        params=tree_map(lambda a: a.clone(), state.unpack(best_flat)),
        train_losses=tr_arr,
        val_losses=val_arr,
        best_epoch=int(np.argmin(val_arr.mean(axis=1))) if len(val_arr) else 0,
        n_members=n_nets,
        history={
            "best_val": best_val.cpu().numpy().tolist(),
            "pruned": pruned,
            "steps_per_epoch": steps_per_epoch,
            **({"member_learning_rates":
                np.asarray(member_learning_rates, np.float64).tolist()}
               if member_learning_rates is not None else {}),
        },
    )


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def _rank_world() -> tuple:
    """(rank, world size) of the running process group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(world: int) -> None:
    if world > 1:
        import torch.distributed as dist

        dist.barrier()


def _rank_file(path: str, rank: int, world: int) -> str:
    return os.path.join(path, f"rank{rank:05d}-of-{world:05d}.pt")


def _drop_checkpoint_dir(path: str) -> None:
    """Remove a directory checkpoint: rank 0 removes it after every rank
    has finished with it."""
    import shutil

    rank, world = _rank_world()
    _barrier(world)
    if rank == 0:
        shutil.rmtree(path)
    _barrier(world)


def save_checkpoint(path: str, state: dict, backend: str = "pickle") -> None:
    """Atomically persist a training state of plain Python, numpy and
    tensors.

    backend "pickle": one file. backend "orbax": `path` is a directory in
    which every rank of the process group (rank 0 alone without one)
    writes its own state, `rank{r}-of-{n}.pt`; the directory is written
    beside `path` and replaces it once every rank has written, so a crash
    leaves the previous checkpoint whole. All ranks must call it."""
    if backend == "orbax":
        import shutil

        rank, world = _rank_world()
        tmp = path + ".tmp-new"
        if rank == 0:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        _barrier(world)
        torch.save(state, _rank_file(tmp, rank, world))
        _barrier(world)
        if rank == 0:
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
        _barrier(world)
        return
    if backend != "pickle":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, path)


def load_checkpoint(path: str, backend: str = "pickle") -> dict:
    """Inverse of `save_checkpoint`: for "orbax", this rank's state (the
    world size must be the one that wrote it). Load only files this program
    wrote: unpickling can run code."""
    if backend == "orbax":
        rank, world = _rank_world()
        f = _rank_file(path, rank, world)
        if not os.path.exists(f):
            raise FileNotFoundError(
                f"{f}: no state for rank {rank} of {world} (written by "
                "another world size?)")
        return torch.load(f, weights_only=False)
    if backend != "pickle":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    with open(path, "rb") as f:
        return pickle.load(f)
