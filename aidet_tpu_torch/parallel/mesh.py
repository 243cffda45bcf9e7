"""The data mesh: the group's ranks along one ``data`` axis.

Port of `aidet_tpu/parallel/mesh.py` (`create_mesh`, `shard_batch`,
`replicate`).  The reference lays a 1-D ``data`` mesh over its devices
and lets XLA insert the gradient all-reduce; here one process drives
one card, so the mesh is the process group's ranks, the batch's rows
are split over them (`shard_batch`), and the step all-reduces its
gradients itself (`parallel.train.make_train_step`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .dist import global_rows, rank, world_size


@dataclass(frozen=True)
class Mesh:
    """A 1-D ``data`` mesh: the process group's ``size`` ranks, this
    process at ``rank``."""
    size: int
    rank: int


def create_mesh(n_devices: int | None = None) -> Mesh:
    """The 1-D ``data`` mesh over the group's ranks (a mesh of one
    without a group).  ``n_devices``, where given, must be the group's
    world size."""
    world = world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a process "
                         f"group of world size {world}: one process "
                         "drives one card")
    return Mesh(world, rank())


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows (`global_rows`) of a global batch: every array
    or tensor with a leading batch axis divisible by the mesh's size is
    cut; a 0-d one is kept whole."""
    def cut(x):
        if getattr(x, "ndim", 0) == 0:
            return x
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"a global batch of {n} rows over a mesh of "
                             f"{mesh.size}")
        rows = global_rows(n // mesh.size, mesh.rank, mesh.size)
        return x[rows.start:rows.stop]
    return {k: cut(v) for k, v in batch.items()}


@torch.no_grad()
def replicate(tensors, mesh: Mesh):
    """Broadcast rank 0's tensors (a module's parameters and buffers, or
    a list such as the momentum trace) to every rank, in place; returns
    its argument.  Nothing moves on a mesh of one."""
    if mesh.size == 1:
        return tensors
    items = (list(tensors.parameters()) + list(tensors.buffers())
             if isinstance(tensors, torch.nn.Module) else list(tensors))
    for t in items:
        dist.broadcast(t.data, src=0)
    return tensors
