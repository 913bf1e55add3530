"""Named-axis meshes over the ranks of a ``torch.distributed`` world.

Counterpart of the JAX package's ``parallel/mesh.py``. There a mesh is a
grid of devices and XLA compiles the collectives of each axis; here each
rank is one process driving one device, and a mesh is a grid of ranks with
one process group for every line of every axis. A rank's coordinates follow
``np.arange(world).reshape(sizes)``, the device order of the JAX package's
``np.array(devices).reshape(sizes)``: for ``{"data": 2, "seq": 2}`` ranks 0
and 1 share data index 0 and form one ``seq`` group.

Nothing is read from the environment: ``init_distributed`` takes the
backend, the store, the rank and the world size from its caller.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import DEFAULT_DEVICE, resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def init_distributed(backend: str, store_path: str, rank: int,
                     world_size: int, timeout_s: float = 300.0) -> None:
    """Join a world of ``world_size`` processes as ``rank``, meeting the
    others through a ``FileStore`` at ``store_path`` (a path every rank
    can reach). A collective that waits longer than ``timeout_s`` raises
    instead of hanging."""
    store = dist.FileStore(str(store_path), world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))


class Mesh:
    """This rank's view of a named-axis grid of ranks: the axis sizes
    (``shape``, in axis order), its coordinate on each axis, the process
    group of its line along each axis and the device it computes on."""

    def __init__(self, shape: dict, rank: int, coords: dict, groups: dict,
                 device: torch.device):
        self.shape = dict(shape)
        self.rank = rank
        self.coords = dict(coords)
        self.device = device
        self._groups = groups

    def group(self, axis: str):
        """The process group of the ranks that share every coordinate of
        this rank but ``axis``; group rank i is the rank at index i."""
        return self._groups[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device})")


def make_mesh(shape: Optional[dict] = None,
              device=DEFAULT_DEVICE) -> Mesh:
    """A mesh over the initialised world. ``shape`` maps axis name → size,
    e.g. ``{"data": 2, "seq": 2}``; the default puts every rank on the
    ``data`` axis. The sizes must multiply to the world size. Every rank
    must call this with the same ``shape``: each call creates one process
    group per line of every axis, on every rank, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "world: call init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if not shape:
        shape = {DATA_AXIS: world}
    names, sizes = list(shape), [int(s) for s in shape.values()]
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{int(np.prod(sizes))} ranks, the world has {world}")
    grid = np.arange(world).reshape(sizes)
    coords = {n: int(c) for n, c in zip(names, np.argwhere(grid == rank)[0])}
    groups = {}
    for k, name in enumerate(names):
        for line in np.moveaxis(grid, k, -1).reshape(-1, sizes[k]):
            members = [int(r) for r in line]
            g = dist.new_group(members)
            if rank in members:
                groups[name] = g
    return Mesh(dict(zip(names, sizes)), rank, coords, groups,
                resolve_device(device))


def data_seq_mesh(seq_size: int = 0, device=DEFAULT_DEVICE) -> Mesh:
    """The mesh ``{"data": world // sp, "seq": sp}`` over the initialised
    world, ``sp = seq_size`` or, for 0, the whole world: the JAX package's
    ``DeepTextClassifier`` mesh (its ``seqAxisSize``). The world size must
    divide by ``sp``: every rank of a ``torch.distributed`` world takes part
    in its collectives, where the JAX package may leave devices out."""
    if not dist.is_initialized():
        raise RuntimeError("data_seq_mesh needs an initialised "
                           "torch.distributed world: call init_distributed "
                           "first")
    world = dist.get_world_size()
    sp = int(seq_size) or world
    if sp < 1 or world % sp:
        raise ValueError(f"seq axis of {sp} ranks does not divide the world "
                         f"of {world}")
    return make_mesh({DATA_AXIS: world // sp, SEQ_AXIS: sp}, device)
