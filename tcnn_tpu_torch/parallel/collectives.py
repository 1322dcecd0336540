"""The collectives of the parallel layer, over ``torch.distributed``.

The JAX package gets its collectives from XLA's partitioner under ``jit``
over a mesh; here they are explicit, and every ``all_reduce`` the layer
issues goes through ``all_reduce`` below and adds one to ``ALL_REDUCES``
(the step's collectives: one a data-parallel step). A mesh is a
``torch.distributed.device_mesh.DeviceMesh``; ``axis`` reads one of its
named dimensions. Any backend serves: NCCL, or gloo (on the CPU, and for
several ranks on one card; it takes all_reduce, broadcast and all_gather
on CUDA tensors too).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

# all_reduce calls issued by the parallel layer (each adds one).
ALL_REDUCES = 0


def all_reduce(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sums ``tensor`` in place over the ranks of ``group``; returns it."""
    global ALL_REDUCES
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    ALL_REDUCES += 1
    return tensor


def axis(mesh, name: str) -> Tuple[object, int, int]:
    """(process group, size, this rank's index) of the mesh dimension
    ``name``; a name the mesh does not have is a dimension of size 1 (no
    group)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a torch.distributed DeviceMesh (parallel.make_mesh), not {type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    if name not in names:
        if mesh.ndim == 1 and not names:
            return mesh.get_group(), mesh.size(), mesh.get_local_rank()
        return None, 1, 0
    dim = names.index(name)
    return mesh.get_group(name), mesh.size(dim), mesh.get_local_rank(name)


def broadcast_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Overwrites ``tensor`` in place with the one of the group's first
    rank."""
    if group is not None:
        dist.broadcast(tensor, src=dist.get_global_rank(group, 0), group=group)
    return tensor


def gather_rows(local: torch.Tensor, group, size: int) -> torch.Tensor:
    """The rows of every rank of ``group``, in rank order: (size * B, ...)
    from each rank's (B, ...) ``local``."""
    if size == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def rows_of(index: int, count: int, n: int) -> slice:
    """Rank ``index``'s contiguous rows of ``n`` split into ``count`` equal
    shards."""
    b = n // count
    return slice(index * b, (index + 1) * b)
