"""A ``('data', 'model')`` grid of ranks over ``torch.distributed``
(``simulgen_vae_tpu/parallel/mesh.py``).

One process per device. :func:`initialize_distributed` joins the process
group torchrun describes in the environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``): NCCL for ``cuda:LOCAL_RANK``,
gloo on the CPU. :func:`make_mesh` lays the ranks out as JAX's ``make_mesh``
lays devices out: ``data`` defaults to ``world // model``, and contiguous
ranks share the model axis (rank ``= d * model + m``). The mesh holds one
process group per line of each axis; every rank creates every group, in the
same order, as ``dist.new_group`` requires.

With one rank and no rendezvous configured nothing is initialised and the
mesh is ``1 x 1``: the trainer and the serving function then run the
one-device path.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

# How long a rendezvous or a collective may wait for the other ranks.
TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(device, backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``device`` is the caller's (``utils.resolve_device`` for a user's
    choice); a bare ``cuda`` becomes ``cuda:LOCAL_RANK``, which is made
    current before the group is joined. The backend follows the device
    (``nccl`` on a card, ``gloo`` on the CPU) unless ``backend`` names one:
    two ranks sharing one card take ``gloo`` with CUDA tensors, since NCCL
    refuses two ranks on one device. ``init_method`` defaults to ``env://``.
    A no-op (the device is still returned) when the group exists already;
    for one rank with no rendezvous in the environment and no
    ``init_method`` the device comes back as it was given."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    if world == 1 and init_method is None and "MASTER_ADDR" not in os.environ:
        return device
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dist.is_available() and dist.is_initialized():
        return device
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world,
                            rank=rank, timeout=TIMEOUT)
    atexit.register(dist.destroy_process_group)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    """True on rank 0, the process that owns every file the run writes."""
    return rank() == 0


def sync_processes(tag: str = "sync") -> None:
    """A barrier across all ranks (nothing with one rank). ``tag`` names the
    point in errors."""
    if world_size() > 1:
        try:
            dist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"sync_processes({tag!r}) failed: {e}") from e


def mesh_grid(world: int, data: Optional[int] = None, model: int = 1) -> np.ndarray:
    """The ``[data, model]`` grid of ranks for ``world`` ranks, by JAX's
    rules: ``data`` defaults to ``world // model``; ``ValueError`` when the
    world is not divisible by ``model`` or ``data * model`` exceeds it."""
    if data is None:
        if world % model != 0:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} exceeds {world} ranks")
    return np.arange(data * model).reshape(data, model)


class Mesh:
    """This rank's view of the grid: ``shape`` ``{"data": D, "model": M}``,
    its ``coords`` and one process group for its line of each axis
    (``group(axis)``: None where that line holds this rank alone, so that no
    collective is called)."""

    def __init__(self, grid: np.ndarray, rank_: int, groups: Optional[Dict[str, object]] = None):
        self.grid = grid
        self.shape = {"data": int(grid.shape[0]), "model": int(grid.shape[1])}
        self.size = int(grid.size)
        self.rank = rank_
        at = np.argwhere(grid == rank_)[0]
        self.coords = {"data": int(at[0]), "model": int(at[1])}
        self._groups = groups or {}

    def group(self, axis: str):
        """The process group of this rank's line of ``axis``, or None."""
        if self.shape[axis] == 1:
            return None
        return self._groups[axis]

    def everyone(self):
        """The group of every rank, or None for a one-rank grid."""
        return None if self.size == 1 else dist.group.WORLD

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The ``('data', 'model')`` mesh over the ranks of the process group
    (one rank when none is initialised). Every rank must call it, with the
    same arguments. The grid must hold every rank: with one process per
    device, a rank left out would have nothing to run."""
    world = world_size()
    grid = mesh_grid(world, data, model)
    if grid.size != world:
        raise ValueError(f"mesh {grid.shape[0]}x{grid.shape[1]} leaves ranks out of {world}")
    me = rank()
    if world == 1:
        return Mesh(grid, me)
    groups: Dict[str, object] = {}
    for d in range(grid.shape[0]):           # the model axis: contiguous ranks
        g = dist.new_group([int(r) for r in grid[d]])
        if me in grid[d]:
            groups["model"] = g
    for m in range(grid.shape[1]):
        g = dist.new_group([int(r) for r in grid[:, m]])
        if me in grid[:, m]:
            groups["data"] = g
    return Mesh(grid, me, groups)
