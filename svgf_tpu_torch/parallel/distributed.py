"""Process-group bootstrap (svgf_tpu/parallel/distributed.py), one process
per GPU.

`init_distributed()` reads what torchrun sets: RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT. A rank computes on
cuda:LOCAL_RANK over NCCL, or, when the caller asks for the CPU, on the
CPU over gloo (the tests). It never falls back from the card to the CPU:
without CUDA, or without NCCL, a CUDA rank raises. A single process with
nothing configured is a no-op.

    torchrun --nproc-per-node=4 my_script.py     # calls init_distributed()

`make_row_mesh()` then names this rank's place in the default group.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from svgf_tpu_torch.core.scene import target_device


class RowMesh(NamedTuple):
    """A 1-D row mesh over the default process group: rank `rank` of
    `size` holds image rows [rank * Hs, (rank + 1) * Hs), Hs = H // size."""

    rank: int
    size: int


def init_distributed(device: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     timeout: float | None = None) -> torch.device:
    """Join the default process group, if one is configured (idempotent),
    and return the device this rank computes on.

    Arguments default to torchrun's variables (RANK, WORLD_SIZE,
    LOCAL_RANK; MASTER_ADDR/MASTER_PORT for the env:// rendezvous). The
    device is cuda:LOCAL_RANK with NCCL unless `device` is "cpu", which
    takes gloo. With no init_method and no MASTER_ADDR nothing is joined.
    `timeout` (seconds) bounds every collective of the group."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = target_device("cpu" if device == "cpu" else f"cuda:{local_rank}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world_size != 1:
            raise RuntimeError(f"WORLD_SIZE={world_size} but no MASTER_ADDR or init_method")
        return dev
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available to this torch build")
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, **kw)
    return dev


def make_row_mesh() -> RowMesh:
    """The row mesh over the default process group, or of one process
    when no group is initialised."""
    if not dist.is_initialized():
        return RowMesh(rank=0, size=1)
    return RowMesh(rank=dist.get_rank(), size=dist.get_world_size())
