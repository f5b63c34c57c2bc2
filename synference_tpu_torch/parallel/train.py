"""Sharded NPE training: data parallel × ensemble parallel.

The members of an ensemble split over the mesh's "ensemble" axis (each rank
holds its members' stacked parameters), every minibatch over "data" (each
rank its rows); a step takes each member's loss on the rank's rows, its
gradient, the mean of the gradients over "data" by `all_reduce`, then the
trainer's clip and AdamW (`train._optimizer_step`), so at world size 1 it
is `train_ensemble`'s step on the same batch, bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..flows.base import tree_map
from ..train import TrainConfig, _npe_loss, _optimizer_step, _pack
from .mesh import axis_info, shard_along

__all__ = ["init_sharded_ensemble", "init_opt_state",
           "make_sharded_train_step", "place_batch"]


def init_sharded_ensemble(flow, generator: torch.Generator, theta, x,
                          n_members: int, mesh,
                          ensemble_axis: str = "ensemble"):
    """Initialise all `n_members` (standardised on θ, x) and return this
    rank's block of them along "ensemble"; every rank must pass a generator
    in the same state, so that the ranks agree on the ensemble."""
    size, rank, _ = axis_info(mesh, ensemble_axis)
    if n_members % size:
        raise ValueError(f"{n_members} members do not divide over {size} "
                         f"ranks of {ensemble_axis!r}")
    params = flow.init(generator, theta, x, n_members=n_members)
    local = n_members // size
    return tree_map(lambda a: a[rank * local:(rank + 1) * local].clone(),
                    params)


def init_opt_state(params) -> dict:
    """AdamW state of stacked parameters: first and second moments of
    their (K, P) buffer, and the step count."""
    flat, _ = _pack(params)
    return {"m": torch.zeros_like(flat), "v": torch.zeros_like(flat),
            "step": 0}


def place_batch(arr, mesh, data_axis: str = "data"):
    """This rank's rows of a global batch, on its device."""
    return shard_along(torch.as_tensor(arr, dtype=torch.float32), mesh,
                       data_axis, 0)


def make_sharded_train_step(flow, mesh, config: TrainConfig | None = None,
                            data_axis: str = "data"):
    """Build step(params, opt_state, θ rows, x rows) -> (params, opt_state,
    (K,) losses), where params are this rank's members and the rows its
    block of the minibatch (`place_batch`). The losses are the members'
    mean over the whole minibatch. `config` gives the learning rate, the
    clip and the weight decay (`TrainConfig` defaults). Returns (step,
    place), where place(arr) is `place_batch` on this mesh."""
    cfg = config or TrainConfig()
    loss_fn = _npe_loss(flow)
    size, _, group = axis_info(mesh, data_axis)

    def step(params, opt_state, tb, xb):
        flat, unpack = _pack(params)
        k = flat.shape[0]
        flat.requires_grad_()
        loss = loss_fn(unpack(flat), tb.expand(k, *tb.shape),
                       xb.expand(k, *xb.shape))
        (grad,) = torch.autograd.grad(loss.sum(), flat)
        with torch.no_grad():
            loss = loss.detach().clone()
            if group is not None:
                dist.all_reduce(grad, group=group)
                dist.all_reduce(loss, group=group)
                grad /= size
                loss /= size
            flat = flat.detach()
            m, v = opt_state["m"].clone(), opt_state["v"].clone()
            count = opt_state["step"] + 1
            lrs = torch.full((k,), cfg.learning_rate, device=flat.device)
            _optimizer_step(flat, grad, m, v, count, lrs, cfg.clip_max_norm,
                            cfg.weight_decay)
        new = tree_map(lambda a: a.clone(), unpack(flat))
        return new, {"m": m, "v": v, "step": count}, loss

    def place(arr):
        return place_batch(arr, mesh, data_axis)

    return step, place
