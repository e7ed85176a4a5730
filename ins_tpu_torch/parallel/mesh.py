"""The 1-D device mesh of the x-slab decomposition.

Port of `ins_tpu/parallel/mesh.py` for the mesh the halo path runs: the
ranks of a `torch.distributed` process group laid along the spatial axis
"x", one device per rank, each holding a contiguous slab of x-planes.
Where the JAX package places a global array with a sharding, here every
rank keeps its own slab (`shard_state`) and the halo path exchanges
planes and transposes with collectives (`parallel/halo.py`).  2-D pencil
meshes are ROADMAP queue 1 item 11.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from .halo import shard_interior, shard_scalar

__all__ = ["Mesh", "make_mesh", "shard_state"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``size`` ranks of ``group`` (None: the default group)
    along "x"; this process is ``rank`` and steps its slab on
    ``device``."""

    group: Any
    rank: int
    size: int
    device: torch.device


def _default_device():
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the halo path runs on the card by "
            "default; pass device=\"cpu\" to make_mesh to run on the CPU"
        )
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(shape=None, *, group=None, device=None):
    """The x-slab mesh over the ranks of ``group`` (default: the default
    process group).  ``shape`` may name its one extent, ``(size,)``.
    ``device`` defaults to ``cuda:<local rank>``; pass ``"cpu"`` for a
    gloo group on the CPU.  Where no process group exists and the world
    has one rank (no ``WORLD_SIZE`` above 1), a one-rank group is made
    here on an in-memory store: NCCL on a card, gloo on the CPU."""
    if shape is not None and len(tuple(shape)) != 1:
        raise NotImplementedError(
            f"mesh shape {tuple(shape)}: 2-D pencil meshes are not ported yet "
            "(ROADMAP queue 1 item 11); the port runs the 1-D x-slab mesh"
        )
    device = torch.device(device) if device is not None else _default_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if group is None and not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != 1:
            raise RuntimeError(
                f"WORLD_SIZE is {world} but torch.distributed is not initialised: "
                "call init_process_group on every rank before make_mesh"
            )
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1,
        )
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if shape is not None and tuple(shape)[0] != size:
        raise ValueError(f"mesh shape {tuple(shape)} does not match {size} ranks")
    return Mesh(group=group, rank=rank, size=size, device=device)


def shard_state(mesh, u, temp=None):
    """This rank's x-slab of a ghost-free interior velocity ``(3, nx, ny,
    nz)`` (and temperature ``(nx, ny, nz)``) on the mesh's device."""
    return shard_interior(mesh, u), None if temp is None else shard_scalar(mesh, temp)
