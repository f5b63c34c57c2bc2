"""Device meshes over the process group, and the per-axis helpers the other
modules share."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "shard_along", "axis_info", "mesh_device",
           "gather_rows"]


def make_mesh(shape: tuple | None = None, axis_names: tuple = ("data",), *,
              device):
    """A `DeviceMesh` over every rank of the process group.

    Args:
        shape: per-axis sizes; default puts all ranks on the first axis.
        axis_names: e.g. ("data",) or ("ensemble", "data").
        device: "cuda" or "cpu", the device type of every rank (the group's
            backend must serve it: NCCL for "cuda", gloo for "cpu").
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call initialize_multihost "
                           "first")
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    """The device this rank drives on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_info(mesh, axis_name: str):
    """(size, this rank's index, process group) of a mesh axis; an axis
    the mesh does not have counts as size 1."""
    if axis_name not in (mesh.mesh_dim_names or ()):
        return 1, 0, None
    return (mesh.size(mesh.mesh_dim_names.index(axis_name)),
            mesh.get_local_rank(axis_name), mesh.get_group(axis_name))


def gather_rows(t, mesh, axis_name: str = "data"):
    """Every rank's (n, ...) tensor of the axis, concatenated in rank order
    along dim 0, on every rank (equal n on every rank)."""
    size, _, group = axis_info(mesh, axis_name)
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def shard_along(arr, mesh, axis_name: str = "data", dim: int = 0):
    """This rank's block of `arr` along `dim` (its size must divide by the
    axis size), on the rank's device."""
    size, rank, _ = axis_info(mesh, axis_name)
    t = torch.as_tensor(arr, device=mesh_device(mesh))
    if t.shape[dim] % size:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not "
                         f"divide over {size} ranks of {axis_name!r}")
    local = t.shape[dim] // size
    return t.narrow(dim, rank * local, local)
