"""The collectives of the mesh axes, over ``torch.distributed``.

The ``seq`` axis (ring and Ulysses attention) and the ``data`` axis of the
trainer's gradient sum come first; the psum family of the distributed GBDT
histogram wires, with its blockwise-quantized pair, follows it (see the
notes there on sum order and on the integer wire).

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
the whole collective calls, staging included, by the primitive that ran
(the psum family's time lands on its gather or all-to-all). Both count the forward and
the backward calls alike.

Hooks. Every public helper first calls ``_chaos(op)``: the elastic
watchdog's heartbeat (``_WATCHDOG_HOOK``), then the fault-injection hook
(``_CHAOS_HOOK``), before it moves data.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.distributed as dist

# Fault-injection hook: when set, every collective helper (and every
# pipeline hop of ``parallel.transfer``) calls it with its op name before it
# moves data, so a test can stall or fail one deterministically. None in
# production; the branch costs one global read.
_CHAOS_HOOK = None

# Elastic-training heartbeat hook (``parallel.elastic.elastic_watchdog``):
# beats this process's heartbeat file with the op name before every
# collective, so a rank that dies inside one leaves its last op on record
# for the peers' ``PeerLostError``.
_WATCHDOG_HOOK = None


def _chaos(name: str) -> None:
    hook = _WATCHDOG_HOOK
    if hook is not None:
        hook(name)       # beat before chaos: a killed op still leaves a trail
    if _CHAOS_HOOK is not None:
        _CHAOS_HOOK(name)


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
    _chaos("all_to_all")
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
    _chaos("ppermute")
    if dist.get_world_size(group) == 1:
        return x
    return _PermuteNext.apply(x, group)


def all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every group rank's ``x`` concatenated along ``axis`` in group-rank
    order (``jax.lax.all_gather(x, axis_name, axis=axis, tiled=True)``).
    Differentiable (the backward is a reduce-scatter-sum)."""
    _chaos("all_gather")
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
    _chaos("psum")
    if dist.get_world_size(group) == 1:
        return x
    return _Psum.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (default: the world), written into
    ``x`` and returned; every rank gets the same value. No gradient."""
    _chaos("all_reduce_sum")
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


# ---------------------------------------------------------------------------
# The psum family of the histogram wires (the JAX package's
# ``parallel/collectives.py``: ``allreduce_sum`` .. ``axis_rank``).
#
# Sum order. XLA's CPU all-reduce folds the devices' values in device order
# (``((x0 + x1) + x2) + ...``, in float32 for bf16 operands, rounded once at
# the end); gloo's ring folds each chunk from a different rank. So the float
# sums here gather every rank's value and fold it in group-rank order on
# every rank: the result is bitwise the same on every rank and bitwise the
# JAX package's on the same per-rank inputs. For two ranks the gather moves
# the bytes a ring all-reduce would (one payload each way). The integer
# grid sums of the quantized wires are exact in any order and use gloo's
# all-reduce directly.
# ---------------------------------------------------------------------------

def _fold(parts: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """(p, ...) → the sum over the leading axis in index order; a bf16 or
    float16 stack is summed in float32 and rounded once to its dtype."""
    acc_dtype = (torch.float32 if parts.dtype in (torch.bfloat16,
                                                  torch.float16)
                 else parts.dtype)
    acc = parts[0].to(acc_dtype).clone()
    for i in range(1, parts.shape[0]):
        acc += parts[i].to(acc_dtype)
    return acc.to(out_dtype or parts.dtype)


def _stacked(x: torch.Tensor, group) -> torch.Tensor:
    """(p, *x.shape): every group rank's ``x`` in group-rank order."""
    return _all_gather(x.detach().unsqueeze(0).contiguous(), group, 0)


def allreduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over ``group`` in group-rank order,
    out of place, bitwise the same on every rank (see above). A bf16
    tensor travels as bf16 and is summed in float32, rounded once."""
    _chaos("allreduce_sum")
    if dist.get_world_size(group) == 1:
        return x.clone()
    return _fold(_stacked(x, group))


def allreduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmean``: :func:`allreduce_sum` over the group size."""
    return allreduce_sum(x, group) / dist.get_world_size(group)


def reduce_scatter_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum_scatter(x, scatter_dimension=0, tiled=True)``: group rank
    ``r`` gets the sum over ranks of chunk ``r`` of ``x``'s leading axis
    (which the group size must divide), folded in group-rank order. Each
    rank sends every other rank its chunk (an all-to-all: the bytes of a
    reduce-scatter) and sums what it receives."""
    _chaos("reduce_scatter_sum")
    p = dist.get_world_size(group)
    if x.shape[0] % p:
        raise ValueError(f"leading axis {x.shape[0]} must divide the group "
                         f"size {p}")
    if p == 1:
        return x.clone()
    got = _all_to_all(x.detach().contiguous(), group, 0, 0)
    return _fold(got.unflatten(0, (p, -1)))


def allgather(x: torch.Tensor, group, tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather``: every rank's ``x`` stacked on a new leading axis
    in group-rank order, or concatenated along axis 0 with ``tiled``."""
    _chaos("allgather")
    if tiled:
        return all_gather(x, group, 0)
    if dist.get_world_size(group) == 1:
        return x.unsqueeze(0)
    return _stacked(x, group)


def allreduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmax`` (exact in any order), out of place."""
    _chaos("allreduce_max")
    if dist.get_world_size(group) == 1:
        return x.clone()
    t0 = time.perf_counter()
    buf = _to_host(x.detach().clone())
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    out = _to_device(buf, x.device)
    COMM_SECONDS["all_reduce"] += time.perf_counter() - t0
    return out


def axis_rank(mesh, axis: str = "data") -> int:
    """``lax.axis_index``: this rank's index on ``mesh``'s ``axis``."""
    return mesh.axis_index(axis)


# ---------------------------------------------------------------------------
# Blockwise-quantized collectives, quantize once (EQuARX; the JAX package's
# ``reduce_scatter_sum_quantized`` / ``allreduce_sum_quantized``): a MAX
# all-reduce agrees each ``block``'s max-abs scale over the group, every
# rank snaps its values to that shared int8 grid once, and the integer grid
# values are summed exactly, so the error is at most n · scale / 2 and the
# result is bitwise the JAX package's (its int16 ``psum`` is exact too).
#
# The integer wire. Gloo has no int16 (``RuntimeError: Invalid scalar
# type``) and NCCL neither. The grid sums are integers of magnitude at most
# n · 127, and float16 holds every integer up to 2048 exactly, so every
# partial sum is exact on a float16 wire while n · 127 <= 2048 (n <= 16):
# 2 bytes an element, JAX's int16 width. Above that the wire is int32.
# ---------------------------------------------------------------------------

FP16_EXACT_INT = 2048


def _acc_dtype(n: int, bits: int) -> torch.dtype:
    """The wire dtype of the grid sums over ``n`` ranks: float16 while
    every sum is an integer it holds exactly, else int32."""
    qmax = 2 ** (bits - 1) - 1
    return torch.float16 if n * qmax <= FP16_EXACT_INT else torch.int32


def _shared_scale_quantize(blocks: torch.Tensor, group, bits: int,
                           acc_dtype):
    """(nblocks, block) float32 → (grid values in ``acc_dtype``, (nblocks,)
    float32 scales shared by the group)."""
    qmax = float(2 ** (bits - 1) - 1)
    # XLA turns the division by the constant qmax into a product with its
    # float32 reciprocal; so does this, for the JAX package's scales
    scale = (allreduce_max(blocks.abs().amax(dim=-1), group)
             * float(np.float32(1.0 / qmax)))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe[..., None]), -qmax, qmax)
    # through int32, so that a -0.0 grid value travels as 0
    return q.to(torch.int32).to(acc_dtype), safe


def reduce_scatter_sum_quantized(x: torch.Tensor, group, *, bits: int = 8,
                                 block: int = 256) -> torch.Tensor:
    """Quantized reduce-scatter: group rank ``r`` gets the sum of chunk
    ``r`` of ``x``'s leading axis (which the group size must divide),
    dequantized once by its owner; error at most n · scale / 2."""
    _chaos("reduce_scatter_sum_quantized")
    n = dist.get_world_size(group)
    if n == 1:
        return x.to(torch.float32)
    m = x.shape[0]
    if m % n:
        raise ValueError(f"leading axis {m} must divide axis size {n}")
    chunk = m // n
    if math.prod(x.shape[1:]) * chunk % block:
        raise ValueError(f"chunk elements must divide block={block}")
    blocks = x.to(torch.float32).reshape(n, -1, block)
    q, safe = _shared_scale_quantize(blocks, group, bits,
                                     _acc_dtype(n, bits))
    got = _all_to_all(q.contiguous(), group, 0, 0).unflatten(0, (n, -1))
    s = got[0].to(torch.int32 if q.dtype == torch.int32 else torch.float32)
    for i in range(1, n):
        s = s + got[i].to(s.dtype)
    r = dist.get_rank(group)
    out = s.to(torch.float32) * safe[r][:, None]
    return out.reshape(chunk, *x.shape[1:])


def allreduce_sum_quantized(x: torch.Tensor, group, *, bits: int = 8,
                            block: int = 256) -> torch.Tensor:
    """Blockwise-quantized all-reduce: the grid sums are exact and the
    same on every rank, so the float32 result is bitwise identical across
    the group; error at most n · scale / 2."""
    _chaos("allreduce_sum_quantized")
    n = dist.get_world_size(group)
    if n == 1:
        return x.to(torch.float32)
    shape = x.shape
    flat = x.to(torch.float32).reshape(-1)
    m = flat.shape[0]
    mp = -(-m // block) * block
    flat = torch.nn.functional.pad(flat, (0, mp - m))
    q, safe = _shared_scale_quantize(flat.reshape(-1, block), group, bits,
                                     _acc_dtype(n, bits))
    s = all_reduce_sum(q, group)          # exact in any order
    out = (s.to(torch.float32) * safe[:, None]).reshape(-1)
    return out[:m].reshape(shape)


def probe_link_bandwidth(mesh, axis: str = "data", size_bytes: int = 1 << 20,
                         repeats: int = 3) -> float:
    """Measured all-reduce bus bandwidth (bytes/s) over ``mesh``'s ``axis``
    from a timed float32 :func:`allreduce_sum` of ~``size_bytes`` split
    over the ranks (each rank reduces its ``1/n`` of the words, as the JAX
    probe's sharded psum does), the best of ``repeats`` after one warm-up.
    The ranks' best seconds are agreed by a MAX all-reduce, so every rank
    returns the same value (a router deciding on it takes the same branch
    everywhere). Ring convention: ``2 (n - 1) / n`` bytes per payload byte.
    Cache it (``core.tuned.measured_or``): each call runs collectives."""
    n = int(mesh.shape[axis])
    if n <= 1:
        return float("inf")
    group = mesh.group(axis)
    words = max(size_bytes // 4 // n * n, n)
    x = torch.ones(words // n, dtype=torch.float32, device=mesh.device)

    def once() -> float:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        allreduce_sum(x, group)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return time.perf_counter() - t0

    once()
    best = min(once() for _ in range(max(repeats, 1)))
    best = float(allreduce_max(torch.tensor([best], dtype=torch.float64),
                               group)[0])
    return 2.0 * (n - 1) / n * (words * 4) / max(best, 1e-9)
