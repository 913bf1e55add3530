"""Hops between pipeline stage groups, and host copies across them.

Counterpart of the JAX package's ``parallel/transfer.py``. There a hop
between stage-group sub-meshes is a ``device_put`` (one process) or an
all-process rendezvous (several). Here every rank is its own process, so
every hop crosses processes: a gloo ``send`` / ``recv`` from the rank at
(group g, other coordinates c) to the rank at (group g', c). Card tensors
go through pinned host memory, as ``parallel.collectives`` stages them.

* :func:`device_transfer` — the pipeline's hop. Every rank calls every hop
  in schedule order; a rank that is neither source nor target passes and
  joins nothing. The send is posted without waiting (``isend``), and the
  target posts its receive at once and waits for it only when it reads the
  value (:class:`Landing`), so the stages of different groups compute at
  the same time. A hop within one group is the value itself. Host inputs
  (a numpy array: microbatch rows, labels) are taken locally by the target
  ranks, with no message: every rank is given the whole batch.
  The first hop of each ``tag`` sends the value's shape and dtype ahead of
  it; later hops of that tag reuse them (a changed shape raises).
  Deadlock freedom: sends never block, and every blocking wait is for a
  message that comes earlier in the schedule order every rank follows.
* :func:`host_fetch` — the tensors of a stage as its owner holds them, on
  every rank (one broadcast per dtype).
* :func:`share_scalars` — a few floats from one rank to every rank (the
  last stage's loss).

Every hop and fetch beats the watchdog / chaos hook pair shared with
``parallel.collectives`` (``op="transfer.hop"``, ``"transfer.fetch"``)
before it moves data, so a dead peer surfaces as ``PeerLostError`` with
the hop on record, and a test can stall one hop deterministically.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import collectives as _coll

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)
_HEADER = 10        # int64 words: dtype code, ndim, up to 8 dims


def _beat(op: str) -> None:
    # the hook pair of parallel.collectives: elastic_watchdog's heartbeat,
    # then the fault-injection hook
    _coll._chaos(op)


class Hops:
    """The hop state of one pipeline fit on this rank: the shape and dtype
    sent or received once per tag, the sends in flight, and the counters
    (``count`` hops this rank took part in, ``bytes`` it sent and
    received, ``seconds`` it spent staging and waiting)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.specs = {}
        self.pending = []
        self.landings = []
        self.count = 0
        self.bytes = 0
        self.seconds = 0.0

    def reset_counts(self) -> None:
        self.count, self.bytes, self.seconds = 0, 0, 0.0

    def drain(self) -> None:
        """Wait for every send in flight and every receive posted (their
        host buffers are then free). A step that stops early must drain
        too: a receive dropped before its message arrives would leave the
        message to match the next receive posted on its tag."""
        t0 = time.perf_counter()
        for work, _buf in self.pending:
            work.wait()
        for landing in self.landings:
            landing.wait()
        self.pending.clear()
        self.landings.clear()
        self.seconds += time.perf_counter() - t0


class Landing:
    """A hop's value on its target rank: the receive is posted; ``wait()``
    waits for it once and returns the tensor on the device."""

    def __init__(self, hops: Hops, work, buf: torch.Tensor):
        self._hops, self._work, self._buf = hops, work, buf
        self._value = None

    def wait(self) -> torch.Tensor:
        if self._value is None:
            hops = self._hops
            t0 = time.perf_counter()
            self._work.wait()
            self._value = (self._buf if hops.device.type == "cpu"
                           else self._buf.to(hops.device, non_blocking=True))
            hops.seconds += time.perf_counter() - t0
            self._work = self._buf = None
        return self._value


def value(x):
    """A hop's result as a tensor (waiting for a :class:`Landing`)."""
    return x.wait() if isinstance(x, Landing) else x


def _peer(src, dst, me: int) -> int:
    """The rank of ``dst`` at this rank's place in ``src`` (both groups
    list their ranks in the same order of the other coordinates)."""
    return dst.ranks[src.ranks.index(me)]


def device_transfer(x, src, dst, hops: Hops, tag: int,
                    op: str = "transfer.hop"):
    """Move ``x`` from stage group ``src`` to stage group ``dst`` (the
    ``Mesh`` es of ``parallel.stage_submeshes``). Returns, on a rank of
    ``dst``, the value (a tensor, or a :class:`Landing` to ``wait`` on);
    on every other rank None. ``x`` is this rank's tensor on a rank of
    ``src`` (ignored elsewhere), or a host array every rank holds (taken
    locally by the ranks of ``dst``). ``tag`` (> 0) names the stream of
    hops; its messages arrive in the order they were sent."""
    _beat(op)
    me = dist.get_rank()
    in_src, in_dst = me in src.ranks, me in dst.ranks
    if isinstance(x, np.ndarray):
        return (torch.as_tensor(x, device=hops.device) if in_dst else None)
    if src is dst:                 # two stages on one group: no message
        return x if in_dst else None
    if in_src:
        _send(x, _peer(src, dst, me), hops, tag)
        return None
    if in_dst:
        return _recv(_peer(dst, src, me), hops, tag)
    return None


def _send(x: torch.Tensor, peer: int, hops: Hops, tag: int) -> None:
    t0 = time.perf_counter()
    x = x.detach()
    spec = (tuple(x.shape), x.dtype)
    if tag not in hops.specs:
        if len(spec[0]) > _HEADER - 2:
            raise ValueError(f"a hop carries at most {_HEADER - 2} dims, "
                             f"got {spec[0]}")
        head = torch.zeros(_HEADER, dtype=torch.int64)
        head[0], head[1] = _DTYPES.index(x.dtype), len(spec[0])
        head[2: 2 + len(spec[0])] = torch.as_tensor(spec[0])
        hops.pending.append((dist.isend(head, peer, tag=tag), head))
        hops.specs[tag] = spec
    elif hops.specs[tag] != spec:
        raise ValueError(f"hop stream {tag} changed from {hops.specs[tag]} "
                         f"to {spec}")
    buf = _coll._to_host(x)
    hops.pending.append((dist.isend(buf, peer, tag=tag), buf))
    hops.count += 1
    hops.bytes += buf.numel() * buf.element_size()
    hops.seconds += time.perf_counter() - t0


def _recv(peer: int, hops: Hops, tag: int) -> Landing:
    t0 = time.perf_counter()
    if tag not in hops.specs:
        head = torch.zeros(_HEADER, dtype=torch.int64)
        dist.recv(head, peer, tag=tag)
        nd = int(head[1])
        hops.specs[tag] = (tuple(int(d) for d in head[2: 2 + nd]),
                           _DTYPES[int(head[0])])
    shape, dtype = hops.specs[tag]
    buf = torch.empty(shape, dtype=dtype,
                      pin_memory=hops.device.type == "cuda")
    work = dist.irecv(buf, peer, tag=tag)
    hops.count += 1
    hops.bytes += buf.numel() * buf.element_size()
    hops.seconds += time.perf_counter() - t0
    landing = Landing(hops, work, buf)
    hops.landings.append(landing)
    return landing


def host_fetch(tensors: Sequence[torch.Tensor], src: int, group=None,
               op: str = "transfer.fetch") -> List[torch.Tensor]:
    """CPU copies of the world rank ``src``'s ``tensors`` on every rank of
    ``group`` (None: the world). Every rank passes tensors of the same
    shapes and dtypes (its own values, or stale ones, or meta tensors);
    they travel as one broadcast per dtype."""
    _beat(op)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        sizes = [tensors[i].numel() for i in idx]
        if dist.get_rank() == src:
            flat = torch.cat([tensors[i].detach().reshape(-1).cpu()
                              for i in idx])
        else:
            flat = torch.empty(sum(sizes), dtype=dtype)
        dist.broadcast(flat, src, group=group)
        for i, part in zip(idx, flat.split(sizes)):
            out[i] = part.view(tensors[i].shape).clone()
    return out


def share_scalars(values, src: int, group=None) -> List[float]:
    """``values`` (floats) of the world rank ``src`` on every rank of
    ``group`` (None: the world)."""
    buf = torch.as_tensor(np.asarray([float(v) for v in values], np.float64))
    dist.broadcast(buf, src, group=group)
    return [float(v) for v in buf]
