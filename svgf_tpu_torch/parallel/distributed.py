"""Process-group bootstrap (svgf_tpu/parallel/distributed.py), one process
per GPU.

`init_distributed()` reads what torchrun sets: RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT. A rank computes on
cuda:LOCAL_RANK over NCCL, or, when the caller asks for the CPU, on the
CPU over gloo (the tests). It never falls back from the card to the CPU:
without CUDA, or without NCCL, a CUDA rank raises. A single process with
nothing configured is a no-op.

    torchrun --nproc-per-node=4 my_script.py     # calls init_distributed()

`make_row_mesh()` then names this rank's place in the default group;
`make_tile_mesh()` and `make_host_chip_mesh()` lay the group out as a
2-D grid of tiles, process-major.
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


class TileMesh(NamedTuple):
    """A 2-D mesh over the default process group: `rows` x `cols` tiles,
    process-major, so rank r holds tile (r // cols, r % cols): image rows
    [iy * Hs, (iy + 1) * Hs) and columns [ix * Ws, (ix + 1) * Ws), with
    Hs = H // rows and Ws = W // cols. `axes` names the two axes, as
    svgf_tpu's mesh does."""

    rank: int
    rows: int
    cols: int
    axes: tuple = ("ty", "tx")

    @property
    def size(self) -> int:
        return self.rows * self.cols

    @property
    def iy(self) -> int:
        return self.rank // self.cols

    @property
    def ix(self) -> int:
        return self.rank % self.cols


def _group() -> tuple[int, int]:
    """(rank, size) of the default process group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def make_tile_mesh(tiles_y: int, tiles_x: int, axes: tuple = ("ty", "tx")) -> TileMesh:
    """The default process group as a tiles_y x tiles_x TileMesh
    (svgf_tpu/parallel/tiled.py make_tile_mesh), rank-major, so the ranks
    of one host span the x axis, as svgf_tpu's process-major devices do.
    Raises unless the group has tiles_y * tiles_x ranks (one process per
    device: svgf_tpu's mesh may take the first n of more devices, a
    process group cannot)."""
    rank, size = _group()
    if tiles_y * tiles_x != size:
        raise ValueError(f"a {tiles_y} x {tiles_x} mesh needs {tiles_y * tiles_x} ranks, "
                         f"the group has {size}")
    return TileMesh(rank=rank, rows=tiles_y, cols=tiles_x, axes=tuple(axes))


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
    rank, size = _group()
    return RowMesh(rank=rank, size=size)


def make_host_chip_mesh(hosts: int | None = None, chips_per_host: int | None = None,
                        axes: tuple = ("host", "chip")) -> TileMesh:
    """(host, chip) 2-D mesh over the default group
    (svgf_tpu/parallel/distributed.py:54-75): torchrun numbers ranks
    process-major, host by host, so each host's cards form one row of the
    grid (the column axis stays on the host's NVLink, the row axis crosses
    hosts). `chips_per_host` defaults to torchrun's LOCAL_WORLD_SIZE,
    `hosts` to the group's size over it."""
    _, size = _group()
    if chips_per_host is None:
        chips_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", size if hosts is None
                                            else size // hosts))
    if hosts is None:
        hosts = max(size // chips_per_host, 1)
    return make_tile_mesh(hosts, chips_per_host, axes)
