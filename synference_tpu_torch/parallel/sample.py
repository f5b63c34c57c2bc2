"""Sharded posterior sampling and catalogue fitting.

Objects split over the mesh's data axis (padded to a multiple of its
size); each rank draws its objects' samples with the posterior's
support-aware batched sampler (`sample_batch_with_acceptance`: rounds that
reject out-of-support draws, leakage clipped onto the box faces) and the
results are all-gathered. Rank r draws from a generator on its device
seeded with `seed` + r, so at world size 1 the draws are those of
`posterior.sample_batch_with_acceptance` with a generator seeded with
`seed`; the JAX package's one key over the sharded program has no
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import axis_info, gather_rows, mesh_device

__all__ = ["make_sharded_sampler", "pad_objects", "sharded_sample_batch",
           "sharded_fit_catalogue"]


def make_sharded_sampler(posterior, mesh, axis_name: str = "data",
                         n_samples: int = 1000, batched_rounds: int = 4):
    """Returns fn(xs (M, C), seed=0) -> (M, n_samples, D) on every rank,
    this rank sampling its block of the M objects (M must divide by the
    axis size: pad with `pad_objects`)."""
    size, rank, _ = axis_info(mesh, axis_name)
    dev = mesh_device(mesh)

    def fn(xs, seed: int = 0):
        xs = torch.atleast_2d(torch.as_tensor(xs, dtype=torch.float32,
                                              device=dev))
        m = xs.shape[0]
        if m % size:
            raise ValueError(f"{m} objects do not divide over {size} ranks "
                             f"of {axis_name!r}: pad them (pad_objects)")
        local = m // size
        gen = torch.Generator(device=dev).manual_seed(int(seed) + rank)
        with torch.no_grad():
            samples, _ = posterior.sample_batch_with_acceptance(
                xs[rank * local:(rank + 1) * local], n_samples, gen,
                batched_rounds)
        return gather_rows(samples.contiguous(), mesh, axis_name)

    return fn


def pad_objects(xs, multiple: int):
    """Pad the object axis up to a multiple with copies of the first
    object; returns (padded, n_valid)."""
    xs = np.atleast_2d(np.asarray(xs))
    n = xs.shape[0]
    n_pad = int(np.ceil(n / multiple) * multiple)
    if n_pad == n:
        return xs, n
    return np.concatenate([xs, np.repeat(xs[:1], n_pad - n, axis=0)]), n


def sharded_sample_batch(posterior, xs, mesh, n_samples: int = 1000,
                         seed: int = 0, axis_name: str = "data"):
    """Posterior samples for a catalogue, sharded over the axis. Returns
    host numpy (n_objects, n_samples, D)."""
    size, _, _ = axis_info(mesh, axis_name)
    xs_pad, n = pad_objects(np.asarray(xs, np.float32), size)
    fn = make_sharded_sampler(posterior, mesh, axis_name=axis_name,
                              n_samples=n_samples)
    return fn(xs_pad, seed).cpu().numpy()[:n]


def sharded_fit_catalogue(posterior, features, mesh, n_samples: int = 1000,
                          quantiles=(0.16, 0.5, 0.84), seed: int = 0,
                          axis_name: str = "data"):
    """Catalogue quantile table with sharded sampling: each rank reduces
    its objects' samples to quantiles on its device, so only the (M, Q, D)
    summary is gathered. Returns host numpy (n_objects, Q, D)."""
    size, rank, _ = axis_info(mesh, axis_name)
    dev = mesh_device(mesh)
    xs_pad, n = pad_objects(np.asarray(features, np.float32), size)
    xs = torch.as_tensor(xs_pad, device=dev)
    local = xs.shape[0] // size
    gen = torch.Generator(device=dev).manual_seed(int(seed) + rank)
    q = torch.as_tensor(quantiles, dtype=torch.float32, device=dev)
    with torch.no_grad():
        s, _ = posterior.sample_batch_with_acceptance(
            xs[rank * local:(rank + 1) * local], n_samples, gen)
        summary = torch.quantile(s, q, dim=1).movedim(0, 1)  # (m, Q, D)
    return gather_rows(summary.contiguous(), mesh,
                       axis_name).cpu().numpy()[:n]
