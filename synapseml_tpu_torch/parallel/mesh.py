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

Two contracts, as in the JAX package:

* **single controller** (``init_distributed``): the JAX package's one
  process driving a mesh of devices. Every rank is handed the same whole
  inputs and keeps its block of them; ``process_count()`` is 1.
* **multi-controller** (``initialize_distributed``, the JAX name): one
  process per rank, each passing only its own rows. The world meets over a
  ``TCPStore`` at the coordinator address; ``process_count()`` is the world
  size, ``process_index()`` the rank, and ``to_global_rows`` /
  ``host_copy`` / ``assert_equal_across_processes`` are the JAX package's
  multi-host helpers on the gloo world.

ZeRO placement (``zero_sharding``, ``tree_shardings``) is a ``ShardSpec``
per tensor: the dimension the JAX package's ``zero_sharding`` picks, cut
into one block per rank of the ``data`` axis.

Pipeline stage groups (``stage_submeshes``): a mesh with a ``stage`` axis
splits into one sub-mesh per stage coordinate, each keeping the other axes
(their line groups are the parent's), so ``data`` and ``seq`` compose
inside every group; ``make_mesh`` makes each group's process group.
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
STAGE_AXIS = "stage"


# set by initialize_distributed: the world is one process per rank, each
# with its own rows
_MULTI_CONTROLLER = {"on": False}


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "gloo",
                           timeout_s: float = 300.0) -> None:
    """Join a multi-controller world (the JAX package's multi-host
    bootstrap): ``num_processes`` processes meet over a ``TCPStore`` at
    ``coordinator_address`` (``"host:port"``, hosted by process 0), and
    this one joins as ``process_id``. Afterwards ``process_count()`` is
    ``num_processes`` and each process passes its own rows to
    ``train_booster(mesh=...)``. With neither an address nor a process
    count it does nothing (one process)."""
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address, "
                         "num_processes and process_id")
    host, port = str(coordinator_address).rsplit(":", 1)
    store = dist.TCPStore(host, int(port), int(num_processes),
                          is_master=int(process_id) == 0,
                          timeout=timedelta(seconds=timeout_s))
    dist.init_process_group(backend, store=store, rank=int(process_id),
                            world_size=int(num_processes),
                            timeout=timedelta(seconds=timeout_s))
    _MULTI_CONTROLLER["on"] = True


def process_count() -> int:
    """Processes of a multi-controller world (``initialize_distributed``);
    1 otherwise, a single-controller world included."""
    if _MULTI_CONTROLLER["on"] and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's index in a multi-controller world; 0 otherwise."""
    if _MULTI_CONTROLLER["on"] and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_topology() -> dict:
    """The JAX package's topology keys: process index and count, devices
    this process drives and devices of the world (one per rank), and the
    platform (``"gpu"`` when a card is present, else ``"cpu"``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    nproc = process_count()
    return {"process_index": process_index(), "process_count": nproc,
            "local_devices": world // nproc, "global_devices": world,
            "platform": "gpu" if torch.cuda.is_available() else "cpu"}


def _gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` stacked in rank order (a CPU all-gather over
    the world)."""
    x = x.detach().cpu().contiguous()
    got = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(got, x)
    return torch.stack(got)


def assert_equal_across_processes(values, what="local shape") -> None:
    """Raise (rather than hang a collective) when the processes of a
    multi-controller world pass different ``values`` (ints)."""
    if process_count() == 1:
        return
    g = _gather_rows(torch.as_tensor(np.asarray(list(values), np.int64))
                     ).numpy()
    if not (g == g[0]).all():
        raise ValueError(
            f"every process must supply the same {what}; got {g.tolist()}")


def local_mesh_devices(mesh: "Mesh") -> int:
    """Devices (ranks) of ``mesh`` per process; the mesh must take the same
    number from every process (in a multi-controller world: one from
    each)."""
    nproc = process_count()
    ndev = int(np.prod(list(mesh.shape.values())))
    if ndev % nproc:
        raise ValueError(f"mesh has {ndev} devices across {nproc} processes; "
                         "device count must divide evenly")
    if nproc > 1 and sorted(mesh.ranks) != list(range(nproc)):
        raise ValueError(
            f"mesh must take exactly 1 device from each of the {nproc} "
            f"processes; it holds ranks {sorted(mesh.ranks)}")
    return ndev // nproc


def mesh_process_indices(mesh: "Mesh") -> tuple:
    """Sorted indices of the processes owning the mesh's ranks."""
    if process_count() == 1:
        return (0,)
    return tuple(sorted(int(r) for r in mesh.ranks))


def shard_rows(mesh: "Mesh", *arrays):
    """This rank's block of each host array's rows, on the mesh's device:
    the rows padded to a multiple of the ``data`` axis (the last row
    repeated; callers mask the padding) and cut into one block per rank of
    the axis, as ``PartitionSpec("data")`` shards them."""
    ndata = int(mesh.shape[DATA_AXIS])
    out = []
    for a in arrays:
        a = np.asarray(a)
        rem = (-a.shape[0]) % ndata
        if rem:
            a = np.concatenate([a, np.repeat(a[-1:], rem, axis=0)])
        lo, hi = row_block(a.shape[0], mesh)
        out.append(torch.as_tensor(np.ascontiguousarray(a[lo:hi])
                                   ).to(mesh.device))
    return out[0] if len(out) == 1 else tuple(out)


def to_global_rows(mesh: "Mesh", spec, local_np) -> torch.Tensor:
    """This process's equal row shard as its block of a global row-sharded
    array (the JAX package's multi-host ingestion): the block on the mesh's
    device. The global array is the processes' blocks in rank order, so
    its row count is ``process_count()`` times the block's. ``spec`` names
    the sharding, rows over ``data``, for the JAX signature."""
    return torch.as_tensor(np.ascontiguousarray(local_np)).to(mesh.device)


def host_copy(tree):
    """Host (numpy) copy of a tree (dict, list, tuple or leaf) of row
    blocks: in a multi-controller world each leaf is gathered from every
    process and concatenated in rank order along its rows, so every process
    gets the whole arrays; otherwise each leaf as it is."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    x = torch.as_tensor(np.asarray(tree) if not isinstance(
        tree, torch.Tensor) else tree)
    if process_count() == 1:
        return x.detach().cpu().numpy()
    return _gather_rows(x).reshape(-1, *x.shape[1:]).numpy()


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
    (``shape``, in axis order), its rank within the mesh and coordinate on
    each axis, the process group of its line along each axis, the group of
    the whole mesh (``world_group``, None when the mesh is the whole
    world) and the device it computes on. A stage group this rank is not
    in (``stage_submeshes``) has ``rank`` None, no coordinates and no line
    groups: only its shape, world ranks and ``world_group``."""

    def __init__(self, shape: dict, rank: int, coords: dict, groups: dict,
                 device: torch.device, world_group=None, ranks=None,
                 planes=None):
        self.shape = dict(shape)
        # per stage coordinate: (its world ranks, its process group, the
        # one-rank groups of a stage-only mesh), made by make_mesh
        self.planes = planes
        # the world ranks of the mesh, in mesh order
        self.ranks = (list(ranks) if ranks is not None
                      else list(range(int(np.prod(list(shape.values()))))))
        self.rank = rank
        self.coords = dict(coords)
        self.device = device
        self.world_group = world_group
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


def make_mesh(shape: Optional[dict] = None, device=DEFAULT_DEVICE,
              ranks: Optional[list] = None) -> Optional[Mesh]:
    """A mesh over the initialised world, or over its ``ranks`` (in that
    order; default every rank). ``shape`` maps axis name → size, e.g.
    ``{"data": 2, "seq": 2}``; the default puts every rank on the ``data``
    axis. The sizes must multiply to the number of ranks. Every rank of
    the world must call this with the same arguments: each call creates
    the same process groups on every rank, in the same order. A rank
    outside ``ranks`` gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "world: call init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if not shape:
        shape = {DATA_AXIS: len(ranks)}
    names, sizes = list(shape), [int(s) for s in shape.values()]
    if int(np.prod(sizes)) != len(ranks):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{int(np.prod(sizes))} ranks, it is given "
                         f"{len(ranks)}")
    whole = None if len(ranks) == world else dist.new_group(ranks)
    grid = np.asarray(ranks).reshape(sizes)
    groups = {}
    for k, name in enumerate(names):
        for line in np.moveaxis(grid, k, -1).reshape(-1, sizes[k]):
            members = [int(r) for r in line]
            g = dist.new_group(members)
            if rank in members:
                groups[name] = g
    planes = None
    if STAGE_AXIS in names:
        # the pipeline's stage groups (stage_submeshes), made here where
        # every rank of the world takes part
        k = names.index(STAGE_AXIS)
        planes = []
        for g in range(sizes[k]):
            members = [int(r) for r in np.take(grid, g, axis=k).ravel()]
            plane = (None if len(members) == world
                     else dist.new_group(members))
            singles = ({r: dist.new_group([r]) for r in members}
                       if len(names) == 1 else None)
            planes.append((members, plane, singles))
    if rank not in ranks:
        return None
    coords = {n: int(c) for n, c in zip(names, np.argwhere(grid == rank)[0])}
    return Mesh(dict(zip(names, sizes)), ranks.index(rank), coords, groups,
                resolve_device(device), whole, ranks, planes)


def stage_submeshes(mesh: Mesh, num_stages: int):
    """``(groups, assign)`` for MPMD pipeline parallelism (the JAX
    package's ``stage_submeshes``): ``groups[g]`` is a ``Mesh`` over the
    ranks at stage coordinate ``g``, keeping every other axis (a
    stage-only mesh gives each group a ``data`` axis of one rank), and
    ``assign[s] = s % G``, the circular placement of stages on groups.
    The groups are disjoint; a group this rank is not in has ``rank``
    None. Within a group the line groups of the other axes are the parent
    mesh's (the same ranks), and the group's own process group was made
    with the mesh (``make_mesh``), so only the mesh's ranks call this."""
    if STAGE_AXIS not in mesh.shape:
        raise ValueError(
            f"mesh {dict(mesh.shape)} has no {STAGE_AXIS!r} axis; build one "
            "with make_mesh({'stage': G, 'data': D})")
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    if mesh.planes is None:
        raise ValueError("the mesh's stage groups were not made; build the "
                         "mesh with make_mesh")
    others = [n for n in mesh.shape if n != STAGE_AXIS]
    shape = ({n: int(mesh.shape[n]) for n in others} if others
             else {DATA_AXIS: 1})
    me = dist.get_rank()
    groups = []
    for members, plane, singles in mesh.planes:
        if me not in members:
            groups.append(Mesh(shape, None, {}, {}, mesh.device, plane,
                               members))
        elif others:
            groups.append(Mesh(shape, members.index(me),
                               {n: mesh.coords[n] for n in others},
                               {n: mesh.group(n) for n in others},
                               mesh.device, plane, members))
        else:
            groups.append(Mesh(shape, members.index(me), {DATA_AXIS: 0},
                               {DATA_AXIS: singles[me]}, mesh.device, plane,
                               members))
    return groups, [s % len(groups) for s in range(num_stages)]


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


class ShardSpec:
    """Where one tensor lives under ``param_sharding="zero"``: cut into
    ``nshard`` equal blocks along ``dim`` over the mesh's ``axis`` (rank i
    of the axis holds block i), or replicated when ``dim`` is None."""

    def __init__(self, dim: Optional[int], nshard: int,
                 axis: str = DATA_AXIS):
        self.dim, self.nshard, self.axis = dim, int(nshard), axis

    def window(self, shape, i: int) -> tuple:
        """((start, stop), ...) per dim of block ``i`` of a ``shape``
        tensor."""
        out = [(0, int(d)) for d in shape]
        if self.dim is not None:
            b = int(shape[self.dim]) // self.nshard
            out[self.dim] = (i * b, (i + 1) * b)
        return tuple(out)

    def take(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Block ``i`` of the full tensor ``x``, a contiguous copy (the
        tensor itself when replicated)."""
        if self.dim is None:
            return x
        b = x.shape[self.dim] // self.nshard
        return x.narrow(self.dim, i * b, b).contiguous()

    def shard_numel(self, shape) -> int:
        return int(np.prod(shape)) // (1 if self.dim is None
                                       else self.nshard)

    def __repr__(self) -> str:
        return f"ShardSpec(dim={self.dim}, nshard={self.nshard})"


def zero_shard_dim(shape, nshard: int) -> Optional[int]:
    """The JAX package's ZeRO choice: the largest dimension divisible by
    ``nshard`` (the first of equal ones), None when no dimension divides
    (biases smaller than the axis, scalars)."""
    for i in sorted(range(len(shape)), key=lambda j: -shape[j]):
        if shape[i] >= nshard and shape[i] % nshard == 0:
            return i
    return None


def zero_sharding(mesh: Mesh, x, axis: str = DATA_AXIS) -> ShardSpec:
    """ZeRO placement of one tensor over ``mesh``'s ``axis``
    (``parallel/mesh.py:zero_sharding`` of the JAX package)."""
    n = int(mesh.shape.get(axis, 1))
    return ShardSpec(zero_shard_dim(tuple(x.shape), n), n, axis)


def tree_shardings(mesh: Mesh, named, mode: str = "replicated",
                   axis: str = DATA_AXIS) -> dict:
    """{name: ShardSpec} over ``named`` ((name, tensor) pairs):
    ``"zero"``/``"fsdp"`` gives each its :func:`zero_sharding`,
    ``"replicated"`` replicates every one."""
    n = int(mesh.shape.get(axis, 1))
    if mode in ("zero", "fsdp"):
        return {name: zero_sharding(mesh, t, axis) for name, t in named}
    if mode != "replicated":
        raise ValueError(f"unknown sharding mode {mode!r}")
    return {name: ShardSpec(None, n, axis) for name, _ in named}


def row_block(n_rows: int, mesh: Mesh, axis: str = DATA_AXIS) -> tuple:
    """(start, stop) of this rank's contiguous block of ``n_rows`` rows
    (a multiple of the axis size) cut into one equal block per rank of
    ``axis``: the shard of ``PartitionSpec(axis)`` in the JAX package."""
    k = int(mesh.shape[axis])
    if n_rows % k:
        raise ValueError(f"{n_rows} rows do not split into {k} blocks; pad "
                         "them to a multiple of the axis first")
    b = n_rows // k
    i = mesh.axis_index(axis)
    return i * b, (i + 1) * b


def check_same_inputs(mesh: Mesh, what: str, *values) -> None:
    """Raise ``ValueError`` on every rank of ``mesh`` unless every rank
    passed equal ``values`` (compared by a sha256 digest of their reprs,
    numpy arrays by their bytes): a cheap guard run before the first
    collective, so that ranks given different inputs fail instead of
    hanging in a collective whose shapes disagree."""
    import hashlib

    h = hashlib.sha256()
    for v in values:
        if isinstance(v, np.ndarray):
            h.update(repr((v.shape, str(v.dtype))).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(repr(v).encode())
    digest = np.frombuffer(h.digest()[:16], np.int64).copy()
    mine = torch.as_tensor(digest)
    n = dist.get_world_size(mesh.world_group)
    got = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(got, mine, group=mesh.world_group)
    if any(not torch.equal(g, got[0]) for g in got):
        bad = [i for i, g in enumerate(got) if not torch.equal(g, got[0])]
        raise ValueError(f"every rank of the mesh must pass the same {what}; "
                         f"mesh ranks {bad} differ from rank 0")
