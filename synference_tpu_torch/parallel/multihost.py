"""Process-group start-up for runs over several processes or hosts.

Nothing tells a program of its cluster: the coordinator's address, the
world size and the rank come from the arguments or from the usual
environment (`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`). Unlike
the JAX package, a failed start-up propagates."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "global_mesh"]


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *, device):
    """Start the default process group (a no-op when one is running):
    NCCL for a "cuda" device (which must exist: a missing card raises),
    gloo for "cpu". `coordinator_address` is "host:port" (or a URL such as
    "tcp://host:port"), with `num_processes` and `process_id`; without it
    the environment gives them. A "cuda" rank takes the card `LOCAL_RANK`
    (else its rank modulo the cards on the host).

    Returns (rank, world size)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda', but no CUDA device is available")
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if coordinator_address is not None:
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            kw = dict(init_method=url, world_size=int(num_processes),
                      rank=int(process_id))
        else:
            kw = dict(init_method="env://")
        if device.type == "cuda":
            rank = int(kw.get("rank", os.environ.get("RANK", 0)))
            torch.cuda.set_device(int(os.environ.get(
                "LOCAL_RANK", rank % torch.cuda.device_count())))
        dist.init_process_group(backend, **kw)
    return dist.get_rank(), dist.get_world_size()


def global_mesh(axis_names=("data",), shape=None, *, device):
    """A mesh over every rank of every host."""
    from .mesh import make_mesh

    return make_mesh(shape=shape, axis_names=axis_names, device=device)
