"""Multi-process runtime: the process group, each rank's rows of the
global batch, the dense gather of test results, and the global loss
normalisers of a data-parallel train step.

Port of `aidet_tpu/parallel/dist.py` (`init_distributed` :27,
`is_main_process` :76, `local_batch_to_global` :80 as `global_rows`,
`gather_results` :105; parity: mmcv's init_dist and
mmdet/apis/test.py:74-146).  One
process drives one card, as torch's idiom has it: `torchrun` (or
`python -m torch.distributed.run`) starts the processes and
`torch.distributed` joins them, over NCCL on cards and gloo on CPUs.

The reference's train step is one program over the global batch (the
batch sharded over a mesh under `jax.jit`), so each loss normaliser it
computes, a count of positives or a mean over a static shape, is one
over the global batch.  Here each rank computes its own rows' losses,
so inside a data-parallel step (`global_losses`) each normaliser is
made global by `global_count` and `global_mean`: each rank's loss is its
own numerator over the global denominator, the sum over ranks is the
reference's loss over the global batch, and the summed gradients are
its gradient.  Outside such a step, or at world size 1, both are the
plain local reductions, so no one-process number moves.
"""

from __future__ import annotations

import contextlib
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(rank: int | None = None, world_size: int | None = None,
                     local_rank: int | None = None,
                     init_method: str | None = None, device: str = "cuda",
                     backend: str | None = None,
                     timeout_s: float | None = None) -> tuple[int, int]:
    """Join the process group when the run has more than one process.

    The rank, world size and local rank come from the arguments, else
    from torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; the
    rendezvous from ``init_method`` (``tcp://host:port`` or
    ``file:///path``), else from ``MASTER_ADDR`` / ``MASTER_PORT``
    (``env://``).  On the card (``device`` "cuda") the process takes
    card ``LOCAL_RANK`` and the group is NCCL's; with ``device="cpu"``
    or ``backend="gloo"`` it is gloo's (gloo also carries CUDA tensors,
    so that two ranks may share one card, which NCCL refuses).  A
    failing backend raises: NCCL is never swapped for gloo.  A single
    process initialises nothing, unless a launcher configured a
    rendezvous (``MASTER_ADDR``, as torchrun sets it even for one
    process) or ``init_method`` is given, as the reference initialises
    for a configured coordinator.  Calling it again returns the group's
    (rank, world size).  Returns (rank, world size).
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    rank = int(env.get("RANK", "0")) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", "1")) if world_size is None
                  else world_size)
    local_rank = (int(env.get("LOCAL_RANK", "0")) if local_rank is None
                  else local_rank)
    on_card = torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available():
        torch.cuda.set_device(local_rank)
    if world_size == 1 and init_method is None and "MASTER_ADDR" not in env:
        return 0, 1
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    backend = backend or ("nccl" if on_card else "gloo")
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = timedelta(seconds=timeout_s)
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **kwargs)
    return rank, world_size


def world_size() -> int:
    """The group's world size, 1 without a group."""
    return (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 1)


def rank() -> int:
    """This process's rank in the group, 0 without a group."""
    return dist.get_rank() if dist.is_available() \
        and dist.is_initialized() else 0


def backend() -> str | None:
    """The group's backend ("nccl", "gloo"), None without a group."""
    return dist.get_backend() if dist.is_available() \
        and dist.is_initialized() else None


def is_main_process() -> bool:
    return rank() == 0


def barrier():
    """Wait for every rank (nothing without a group)."""
    if world_size() > 1:
        dist.barrier()


def global_rows(n_local: int, rank: int, world: int) -> range:
    """The rows of the global batch that rank ``rank`` holds (the
    counterpart of the reference's `local_batch_to_global`, which
    assembles the global array from them): the global batch of
    ``n_local * world`` rows is the ranks' local batches concatenated
    in rank order, so rank r holds rows r * n_local to (r + 1) * n_local
    - 1, as the reference shards the leading axis over the mesh's
    devices.  Each rank keeps its rows (`GroupedLoader(num_shards=world,
    shard_id=rank)` loads them, `mesh.shard_batch` cuts them from a
    global batch) and nothing moves between ranks."""
    return range(rank * n_local, (rank + 1) * n_local)


def _collective_device():
    """Where the group's collectives take their tensors: the current
    card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(arr: np.ndarray) -> np.ndarray:
    """Every rank's ``arr`` (the same shape and dtype on each) stacked in
    rank order: [world, ...] (booleans travel as uint8)."""
    a = np.ascontiguousarray(arr)
    is_bool = a.dtype == np.bool_
    t = torch.from_numpy(a.view(np.uint8) if is_bool else a).to(
        _collective_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    res = torch.stack(out).cpu().numpy()
    return res.view(np.bool_) if is_bool else res


def gather_results(results: list, num_shards: int, shard_id: int,
                   total: int, allgather=None, example=None) -> list:
    """All-gather per-image result dicts across processes and restore
    dataset order.

    Each process evaluated images ``shard_id::num_shards`` of a dataset
    of ``total``; results are dicts of FIXED-SHAPE numpy arrays (the
    padded detection layout), so the gather is a dense all-gather of one
    [n_max, ...] array per key, the short shards padded with zeros.
    ``allgather`` maps an array to the [num_shards, ...] stack of every
    process's (default `process_allgather`, over the group; injectable
    for in-process tests).  ``example`` (key -> array) gives the
    per-image spec where this process's shard may be empty (num_shards
    > total): every process must then still contribute arrays of the
    same keys and shapes.  Returns the full ordered list on every
    process."""
    if num_shards == 1:
        return results
    allgather = allgather or process_allgather
    template = results[0] if results else example
    if template is None:
        raise ValueError(
            "gather_results: local shard is empty and no `example` "
            "template was given; every process must contribute "
            "identically-shaped arrays to the all-gather")
    keys = sorted(template.keys())
    n_max = -(-total // num_shards)
    stacked = {}
    for k in keys:
        if results:
            arr = np.stack([np.asarray(r[k]) for r in results])
        else:
            t = np.asarray(template[k])
            arr = np.zeros((0,) + t.shape, t.dtype)
        if arr.shape[0] < n_max:
            pad = np.zeros((n_max - arr.shape[0],) + arr.shape[1:],
                           arr.dtype)
            arr = np.concatenate([arr, pad])
        stacked[k] = allgather(arr)                       # [P, n_max, ...]
    ordered = [None] * total
    for s in range(num_shards):
        for j, i in enumerate(range(s, total, num_shards)):
            ordered[i] = {k: stacked[k][s, j] for k in keys}
    return ordered


# the group's world size while a data-parallel loss is computed
_LOSS_WORLD = 1


@contextlib.contextmanager
def global_losses():
    """Within it, `global_count` and `global_mean` normalise over the
    ranks of the process group; without a group (world size 1) it
    changes nothing.  `parallel.train.make_train_step` enters it around
    the model's loss."""
    global _LOSS_WORLD
    saved = _LOSS_WORLD
    _LOSS_WORLD = world_size()
    try:
        yield
    finally:
        _LOSS_WORLD = saved


def global_count(t: torch.Tensor) -> torch.Tensor:
    """A loss normaliser's count (any shape, any dtype), summed over the
    ranks of the data-parallel step, without gradient: call it before
    the count's clamp(min=1).  Outside a data-parallel step it returns
    ``t`` itself."""
    if _LOSS_WORLD == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over the global batch, of which ``x`` (a static
    shape) holds this rank's rows: the sum over x.numel() x world.
    Outside a data-parallel step, ``x.mean()``."""
    if _LOSS_WORLD == 1:
        return x.mean()
    return x.sum() / (x.numel() * _LOSS_WORLD)
