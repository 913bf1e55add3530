"""The collectives of the ``seq`` mesh axis, over ``torch.distributed``.

The JAX package writes them inline as ``lax`` primitives inside
``shard_map``: ``all_to_all(..., tiled=True)`` in ``parallel/ulysses.py`` and
the ring's ``ppermute`` in ``parallel/ring_attention.py``. Here they are
functions of a process group (``Mesh.group(axis)``).

Gradients. ``all_to_all``, ``ppermute_next`` and ``all_gather`` are
``torch.autograd.Function``s whose backward is the transpose XLA derives for
the JAX primitive: ``all_to_all`` with ``split_axis`` and ``concat_axis``
swapped; the rotation the other way round (the cotangent goes to the
*previous* rank); and, for the tiled ``all_gather``, a reduce-scatter-sum
(``psum_scatter``): each rank receives every rank's cotangent of its own
slice and sums them in group-rank order. ``all_reduce_sum`` sums a tensor
over a group in place (the trainer's gradient sum); it has no gradient.
``psum`` is the differentiable sum (``jax.lax.psum``, whose transpose is
itself): BatchNorm's moments over a data axis go through it, so the
backward pass sums their cotangents too.

Transport. The backend the port runs the ``seq`` axis on is gloo: NCCL
refuses two ranks on one card, and a one-card machine runs the axis as two
ranks sharing it. Gloo's point-to-point calls take CPU tensors only, so a
CUDA tensor is staged explicitly through pinned host memory here: the
current stream is synchronised, the tensor copied to a pinned buffer, the
collective run on host tensors, and the result copied back to the device.
The kernels still run on the card; only the transport passes through the
host. ``STAGING`` counts the bytes copied each way and the seconds spent
copying (not waiting on the collective); ``COMM_SECONDS`` the seconds of
the whole collective calls, staging included. Both count the forward and
the backward calls alike.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

STAGING = {"bytes": 0, "seconds": 0.0}
COMM_SECONDS = {"all_to_all": 0.0, "ppermute": 0.0, "all_gather": 0.0,
                "all_reduce": 0.0}


def reset_staging_counts() -> None:
    STAGING["bytes"], STAGING["seconds"] = 0, 0.0
    for k in COMM_SECONDS:
        COMM_SECONDS[k] = 0.0


def _host_buffer(shape, dtype, pinned: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=pinned)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous CPU tensor; a CUDA tensor is copied into pinned
    memory after its stream has finished (so the copy's time is its own)."""
    if x.device.type == "cpu":
        return x.contiguous()
    torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    buf = _host_buffer(x.shape, x.dtype, True)
    buf.copy_(x)
    STAGING["seconds"] += time.perf_counter() - t0
    STAGING["bytes"] += buf.numel() * buf.element_size()
    return buf


def _to_device(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        return buf
    t0 = time.perf_counter()
    out = buf.to(device)
    torch.cuda.current_stream(device).synchronize()
    STAGING["seconds"] += time.perf_counter() - t0
    STAGING["bytes"] += buf.numel() * buf.element_size()
    return out


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    p = dist.get_world_size(group)
    t0 = time.perf_counter()
    send = _to_host(torch.stack(x.chunk(p, dim=split_axis)))
    recv = _host_buffer(send.shape, send.dtype, x.is_cuda)
    dist.all_to_all_single(recv, send, group=group)
    out = torch.cat(_to_device(recv, x.device).unbind(0), dim=concat_axis)
    COMM_SECONDS["all_to_all"] += time.perf_counter() - t0
    return out


def _rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to group rank ``r + shift`` and return what rank
    ``r - shift`` sent (mod p)."""
    p = dist.get_world_size(group)
    t0 = time.perf_counter()
    r = dist.get_rank(group)
    send = _to_host(x)
    recv = _host_buffer(send.shape, send.dtype, x.is_cuda)
    reqs = [dist.isend(send, dist.get_global_rank(group, (r + shift) % p),
                       group=group),
            dist.irecv(recv, dist.get_global_rank(group, (r - shift) % p),
                       group=group)]
    for req in reqs:
        req.wait()
    out = _to_device(recv, x.device)
    COMM_SECONDS["ppermute"] += time.perf_counter() - t0
    return out


def _all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    p = dist.get_world_size(group)
    t0 = time.perf_counter()
    send = _to_host(x)
    recv = [_host_buffer(send.shape, send.dtype, x.is_cuda)
            for _ in range(p)]
    dist.all_gather(recv, send, group=group)
    out = torch.cat([_to_device(t, x.device) for t in recv], dim=axis)
    COMM_SECONDS["all_gather"] += time.perf_counter() - t0
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(g, group, concat_axis, split_axis), None, None, None


class _PermuteNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rotate(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.group, -1), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis)
        return _all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter-sum: slice j of every rank's cotangent goes to rank
        # j, which sums what it receives in group-rank order
        group, axis = ctx.args
        p = dist.get_world_size(group)
        parts = _all_to_all(g, group, split_axis=axis, concat_axis=0)
        return parts.unflatten(0, (p, -1)).sum(0), None, None


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over ``group``: ``x`` is cut into p equal chunks along ``split_axis``,
    chunk j goes to group rank j, and the chunks received are concatenated
    along ``concat_axis`` in the order of the group ranks that sent them.
    Differentiable (the backward swaps the two axes)."""
    p = dist.get_world_size(group)
    if x.shape[split_axis] % p:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{x.shape[split_axis]} does not split into {p}")
    if p == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def ppermute_next(x: torch.Tensor, group) -> torch.Tensor:
    """The ring rotation ``ppermute(x, perm=[(i, (i + 1) % p)])``: send ``x``
    to the next group rank and return what the previous one sent.
    Differentiable (the cotangent travels to the previous rank)."""
    if dist.get_world_size(group) == 1:
        return x
    return _PermuteNext.apply(x, group)


def all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every group rank's ``x`` concatenated along ``axis`` in group-rank
    order (``jax.lax.all_gather(x, axis_name, axis=axis, tiled=True)``).
    Differentiable (the backward is a reduce-scatter-sum)."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, group, axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.detach().clone(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, out of place, on every rank.
    Differentiable: the backward sums the cotangents over the group."""
    if dist.get_world_size(group) == 1:
        return x
    return _Psum.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (default: the world), written into
    ``x`` and returned; every rank gets the same value. No gradient."""
    if dist.get_world_size(group) == 1:
        return x
    t0 = time.perf_counter()
    buf = _to_host(x.detach())
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if x.is_cuda:
        x.detach().copy_(_to_device(buf, x.device))
    elif buf.data_ptr() != x.data_ptr():
        x.detach().copy_(buf)
    COMM_SECONDS["all_reduce"] += time.perf_counter() - t0
    return x
