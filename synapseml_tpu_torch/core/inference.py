"""Shape-bucketed, asynchronous inference runtime (BucketedRunner).

The port's counterpart of the JAX package's ``core/inference.py``. Serving
(``io/serving.py``) and GBDT predict/serving (``gbdt/boosting.py``) feed
micro-batches of any row count into one callable. Scored eagerly on the
card, each call is as many kernel launches as the callable has operations
(forest traversal: about 25 per tree level), and the host's launch time,
not the card, sets the latency of a small batch. The JAX package compiles
one XLA program per batch bucket; here the runner captures one
``torch.cuda.CUDAGraph`` per bucket and replays it, one launch per batch.

:class:`BucketedRunner` wraps one callable with:

* **Bucket ladder** — the batch dimension is padded up to a geometric
  ladder of bucket sizes (1, 2, 4, ... ``max_batch_size`` by default), so
  there is one graph per *bucket*, not per observed size. Batches larger
  than ``max_batch_size`` are chunked into full buckets plus one bucketed
  tail. Padding repeats the last real row (a gather on the host), and
  outputs are sliced back to the real row count, so padded rows never reach
  a reply.
* **Capture ahead of time** — :meth:`warmup` captures every bucket before
  traffic arrives; the steady-state capture count is then zero, which the
  runner's counters show.
* **Asynchronous dispatch** — :meth:`dispatch` copies a batch into the
  bucket's static input on the card, replays the graph, copies the static
  outputs into fresh tensors on the runner's own stream, records an event
  and returns a :class:`PendingBatch` without waiting; the host waits only
  in :meth:`PendingBatch.result`, when the replies are written.
* **Counters** — per-bucket capture ("compile") and replay ("hit") counts
  (:meth:`stats`), with the keys and meanings of the JAX runner.

On the CPU (``device="cpu"``, as the tests run it) the runner calls the
callable eagerly on each padded bucket and counts a compile the first time
it sees a (bucket, argument specs) key, so its counters equal the JAX
runner's for the same calls. On a CUDA device it replays a captured graph
or raises: it never runs the callable eagerly in a graph's place.

``fn`` takes and returns torch tensors: one or more batch-leading inputs on
the runner's device, and one tensor or a tuple or list of them. Inside a
capture it must not wait on the host (``.item()``, ``.cpu()``,
``nonzero``, a host tensor moved to the card): such a call makes the
capture fail, and the runner raises.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["BucketedRunner", "PendingBatch", "RunnerFleet", "bucket_ladder"]

#: Ladder growth when the caller names none: the JAX runner's fallback.
#: (Its learned ladder reads A/B rows recorded on TPUs and CPUs, which say
#: nothing of this card; ``stats()["autoconfig"]`` records the fallback.)
DEFAULT_GROWTH = 2.0

# One capture at a time in the process: the registry warms a new version's
# ladder while the serving thread replays the old one, and requests
# dispatch from several threads at once.
_CAPTURE_LOCK = threading.Lock()


def bucket_ladder(max_batch_size: int, growth: float = 2.0,
                  min_bucket: int = 1) -> Tuple[int, ...]:
    """Geometric ladder of batch buckets: ``min_bucket`` multiplied by
    ``growth`` (rounded up, strictly increasing) until ``max_batch_size``,
    which is always the last rung."""
    if max_batch_size < 1:
        raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
    if not 1 <= min_bucket <= max_batch_size:
        raise ValueError(f"min_bucket must be in [1, {max_batch_size}], "
                         f"got {min_bucket}")
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1.0, got {growth}")
    ladder: List[int] = []
    b = float(min_bucket)
    while b < max_batch_size:
        nxt = int(b) if b == int(b) else int(b) + 1
        if not ladder or nxt > ladder[-1]:
            ladder.append(nxt)
        b *= growth
    if not ladder or ladder[-1] != max_batch_size:
        ladder.append(max_batch_size)
    return tuple(ladder)


def _pad_to(arr: np.ndarray, bucket: int, out: Optional[np.ndarray] = None
            ) -> np.ndarray:
    """Pad the leading dim up to ``bucket`` by repeating the last real row
    (into ``out`` when given, e.g. a pinned staging buffer): a contiguous
    copy of the real rows, then the last row broadcast over the rest;
    repeated rows keep the padded lanes numerically benign (no log(0)
    NaNs)."""
    n = arr.shape[0]
    if out is None and n == bucket:
        return np.ascontiguousarray(arr)
    if out is None:
        out = np.empty((bucket,) + arr.shape[1:], arr.dtype)
    np.copyto(out[:n], arr)
    if n < bucket:
        out[n:] = arr[n - 1]
    return out


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _leaves(out) -> Tuple[list, Optional[type]]:
    """(output tensors, container type or None for a single tensor)."""
    if isinstance(out, torch.Tensor):
        return [out], None
    if isinstance(out, (tuple, list)) and out and all(
            isinstance(o, torch.Tensor) for o in out):
        return list(out), type(out)
    raise TypeError("BucketedRunner: fn must return a tensor or a tuple or "
                    f"list of tensors, got {type(out).__name__}")


class PendingBatch:
    """Handle for dispatched work that the host has not waited on. Every
    chunk's replay is already enqueued; :meth:`result` is the single host
    sync point (where serving writes replies)."""

    def __init__(self, chunks: List[Tuple[list, int, int]], kind,
                 n_total: int, event=None):
        # chunks: (output tensors, real_rows, bucket) per dispatched chunk
        self._chunks = chunks
        self._kind = kind
        self._event = event
        self.num_rows = n_total

    def block_until_ready(self) -> "PendingBatch":
        if self._event is not None:
            self._event.synchronize()
        return self

    def result(self):
        """Outputs as numpy, sliced to the real row count (padded rows never
        leak). Blocks until the card's work for this batch is done."""
        self.block_until_ready()
        per_leaf: Optional[List[List[np.ndarray]]] = None
        for leaves, real, bucket in self._chunks:
            if per_leaf is None:
                per_leaf = [[] for _ in leaves]
            for slot, leaf in zip(per_leaf, leaves):
                host = leaf.cpu().numpy()
                if host.ndim and host.shape[0] == bucket:
                    host = host[:real]
                elif len(self._chunks) > 1:
                    raise ValueError(
                        "BucketedRunner: output leaf has no leading batch "
                        f"dimension (shape {host.shape}) but the input was "
                        "chunked; results cannot be concatenated")
                slot.append(host)
        outs = [parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
                for parts in per_leaf]
        if self._kind is None:
            return outs[0]
        return self._kind(outs)


def _mask(real: int, bucket: int) -> np.ndarray:
    return np.arange(bucket) < real


class _Eager:
    """A (bucket, specs) entry on the CPU: ``fn`` called on the padded
    rung."""

    def __init__(self, fn: Callable, pass_mask: bool):
        self.fn = fn
        self.pass_mask = pass_mask

    def run(self, rows: List[np.ndarray], real: int, bucket: int,
            stream) -> Tuple[list, Any]:
        padded = [_pad_to(a, bucket) for a in rows]
        if self.pass_mask:
            padded.append(_mask(real, bucket))
        with torch.no_grad():
            return _leaves(self.fn(*[torch.from_numpy(p) for p in padded]))


class _Graph:
    """A (bucket, specs) entry on the card: one captured CUDA graph with its
    static inputs and outputs. ``lock`` is the runner's replay lock, one for
    all its rungs: the rungs share one memory pool, so a rung captured later
    may hold its static outputs in memory that an earlier rung uses for
    temporaries. The lock is held from the copy-in through the replay to the
    enqueued copy-out, so no other replay of the runner falls between a
    batch's replay and the copy of its outputs."""

    def __init__(self, fn: Callable, shapes: List[Tuple[tuple, np.dtype]],
                 device: torch.device, pool, pass_mask: bool,
                 lock: threading.Lock):
        self.lock = lock
        self.pass_mask = pass_mask
        self.inputs = [torch.zeros(shape, dtype=_torch_dtype(dtype),
                                   device=device)
                       for shape, dtype in shapes]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad():
            with torch.cuda.stream(side):
                # allocator and library state settle before the capture, as
                # torch.cuda.graph asks; this run reads zeros, not a batch
                _leaves(fn(*self.inputs))
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.outputs, self.kind = _leaves(fn(*self.inputs))

    def run(self, rows: List[np.ndarray], real: int, bucket: int,
            stream) -> Tuple[list, Any]:
        # the padded rows are gathered straight into pinned staging
        # buffers; the caching host allocator keeps each buffer out of
        # reuse until its asynchronous copy has run
        staged = []
        for a, dst in zip(rows, self.inputs):
            host = torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True)
            _pad_to(a, bucket, out=host.numpy())
            staged.append(host)
        if self.pass_mask:
            staged.append(torch.from_numpy(_mask(real, bucket)).pin_memory())
        with self.lock, torch.cuda.stream(stream):
            for dst, src in zip(self.inputs, staged):
                dst.copy_(src, non_blocking=True)
            self.graph.replay()
            outs = [o.clone() for o in self.outputs]
        return outs, self.kind


class BucketedRunner:
    """Shared bucketing + capture-ahead + asynchronous-dispatch execution
    layer.

    ``fn`` is any callable over one or more batch-leading tensors (all
    sharing the leading dimension) returning a tensor or a tuple/list of
    tensors. ``device`` (default ``"cuda"``) is where it runs: one captured
    CUDA graph per (bucket, trailing specs) on a card, ``fn`` itself on
    each padded bucket on the CPU.

    ``donate`` is accepted for the JAX signature and changes nothing: a
    graph's static input already is the reused staging buffer on the card.
    """

    def __init__(self, fn: Callable, max_batch_size: int = 64,
                 growth: Optional[float] = None, min_bucket: int = 1,
                 donate: Optional[bool] = None, pass_mask: bool = False,
                 name: Optional[str] = None, device=DEFAULT_DEVICE):
        self.fn = fn
        self.max_batch_size = int(max_batch_size)
        self._autoconfig: Optional[dict] = None
        if growth is None:
            growth = DEFAULT_GROWTH
            self._autoconfig = {
                "kind": "serving_bucket_growth", "arm": f"g{growth}",
                "predicted_s": None, "confidence": 0.0,
                "used_fallback": True, "fallback_arm": f"g{growth}",
                "source": "fallback",
                "features": {"max_batch_size": float(self.max_batch_size)}}
        self.buckets = bucket_ladder(self.max_batch_size, growth, min_bucket)
        self.donate = donate
        self.pass_mask = pass_mask
        self.name = name or getattr(fn, "__name__", "fn")
        self.device = resolve_device(device)
        self._on_card = self.device.type == "cuda"
        # the stream every copy and replay of this runner is enqueued on
        # (None on the CPU); time the card's work with events on it
        self.stream = None
        self._pool = None
        if self._on_card:
            self.stream = torch.cuda.Stream(self.device)
            # one memory pool for every rung, so the rungs' temporaries
            # share memory; replays then must not interleave (see _Graph)
            self._pool = torch.cuda.graph_pool_handle()
        self._replay_lock = threading.Lock()
        self._compiled: Dict[tuple, Any] = {}
        self._lock = threading.Lock()
        self._compile_counts: Dict[int, int] = {}
        self._hit_counts: Dict[int, int] = {}
        self._warmup_compiles = 0
        # host seconds of each capture, by (bucket, specs)
        self.capture_seconds: Dict[tuple, float] = {}

    # --- bucket selection ------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest ladder rung covering ``n`` (``max_batch_size`` for any
        larger chunked batch)."""
        if n < 1:
            raise ValueError(f"batch of {n} rows has no bucket")
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch_size

    # --- capture ---------------------------------------------------------
    @staticmethod
    def _spec_of(arr) -> Tuple[Tuple[int, ...], np.dtype]:
        a = np.asarray(arr)
        return tuple(a.shape[1:]), a.dtype

    def _build(self, bucket: int, specs: Tuple):
        shapes = [((bucket,) + shape, dtype) for shape, dtype in specs]
        if self.pass_mask:
            shapes.append(((bucket,), np.dtype(np.bool_)))
        if not self._on_card:
            return _Eager(self.fn, self.pass_mask)
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            graph = _Graph(self.fn, shapes, self.device, self._pool,
                           self.pass_mask, self._replay_lock)
        self.capture_seconds[(bucket, specs)] = time.perf_counter() - t0
        return graph

    def _executable(self, bucket: int, specs: Tuple, *, warmup: bool = False):
        """The entry for (bucket, arg specs); captures it on a miss and
        counts it. ``specs`` is a tuple of (trailing-shape, dtype) per arg."""
        key = (bucket, specs)
        with self._lock:
            hit = self._compiled.get(key)
            if hit is not None:
                if not warmup:
                    self._hit_counts[bucket] = \
                        self._hit_counts.get(bucket, 0) + 1
                return hit
        with _CAPTURE_LOCK:
            with self._lock:
                # a racing thread may have captured the same key
                existing = self._compiled.get(key)
            if existing is not None:
                return existing
            built = self._build(bucket, specs)
            with self._lock:
                self._compiled[key] = built
                self._compile_counts[bucket] = \
                    self._compile_counts.get(bucket, 0) + 1
                if warmup:
                    self._warmup_compiles += 1
        return built

    def warmup(self, *templates, persistent_cache: bool = True) -> dict:
        """Capture EVERY bucket for the argument signature described by
        ``templates`` (one array-like per ``fn`` argument; only trailing
        dims and dtype matter — pass a single example row or a full batch).
        ``persistent_cache`` is accepted for the JAX signature and changes
        nothing: a captured graph cannot outlive its process. Returns
        :meth:`stats`."""
        if not templates:
            raise ValueError("warmup needs one template array per fn "
                             "argument (trailing dims + dtype)")
        specs = tuple(self._spec_of(t) for t in templates)
        for bucket in self.buckets:
            self._executable(bucket, specs, warmup=True)
        return self.stats()

    # --- execution -------------------------------------------------------
    def dispatch(self, *args) -> PendingBatch:
        """Launch the computation for ``args`` (host arrays, equal leading
        dim) WITHOUT waiting for the card: batches are padded to their
        bucket, chunked above ``max_batch_size``, and every chunk's replay
        is enqueued before any host sync. Call ``.result()`` on the
        returned handle when (and only when) the replies are written."""
        if not args:
            raise ValueError("dispatch needs at least one batch array")
        arrs = [a if isinstance(a, np.ndarray) else np.asarray(a)
                for a in args]
        n = arrs[0].shape[0] if arrs[0].ndim else 0
        for a in arrs[1:]:
            if a.shape[0] != n:
                raise ValueError(
                    "dispatch arguments disagree on the batch dimension: "
                    f"{[a.shape[0] for a in arrs]}")
        if n == 0:
            raise ValueError("cannot dispatch an empty batch")
        specs = tuple(self._spec_of(a) for a in arrs)
        chunks: List[Tuple[list, int, int]] = []
        kind = None
        for start in range(0, n, self.max_batch_size):
            stop = min(start + self.max_batch_size, n)
            real = stop - start
            bucket = self.bucket_for(real)
            outs, kind = self._executable(bucket, specs).run(
                [a[start:stop] for a in arrs], real, bucket, self.stream)
            chunks.append((outs, real, bucket))
        event = None
        if self._on_card:
            event = torch.cuda.Event()
            event.record(self.stream)
        return PendingBatch(chunks, kind, n, event)

    def __call__(self, *args):
        """Synchronous convenience: ``dispatch(...).result()``."""
        return self.dispatch(*args).result()

    # --- observability ---------------------------------------------------
    def warm_buckets(self) -> List[int]:
        """Ascending bucket sizes holding at least one captured graph."""
        with self._lock:
            return sorted(self._compile_counts)

    def stats(self) -> dict:
        with self._lock:
            compiles = dict(sorted(self._compile_counts.items()))
            hits = dict(sorted(self._hit_counts.items()))
            out = {"name": self.name,
                   "buckets": list(self.buckets),
                   "compiles": compiles,
                   "hits": hits,
                   "warmup_compiles": self._warmup_compiles,
                   "total_compiles": sum(compiles.values()),
                   "total_hits": sum(hits.values())}
            if self._autoconfig is not None:
                out["autoconfig"] = dict(self._autoconfig)
            return out

    def reset_stats(self) -> None:
        """Zero the hit counters (compile counts describe the cache contents
        and are kept — a reset must not hide a later capture)."""
        with self._lock:
            self._hit_counts = {}

    def __repr__(self) -> str:
        return (f"BucketedRunner({self.name!r}, buckets={list(self.buckets)},"
                f" compiled={len(self._compiled)})")


class RunnerFleet:
    """Per-tenant accounting over the runners of a multi-tenant server:
    ``register(tenant, runner)``, ``warm_all()`` off the hot path, and
    :meth:`stats` — per-tenant capture/hit counters plus fleet totals.
    Thread-safe; runners stay owned by their handlers (this holds
    references, never copies)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._runners: Dict[str, BucketedRunner] = {}

    def register(self, tenant: str, runner: BucketedRunner
                 ) -> "RunnerFleet":
        with self._lock:
            self._runners[tenant] = runner
        return self

    def runner(self, tenant: str) -> Optional[BucketedRunner]:
        with self._lock:
            return self._runners.get(tenant)

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._runners)

    def warm_all(self, templates: Dict[str, tuple]) -> dict:
        """Capture every registered runner whose tenant has a template
        tuple in ``templates`` (one array-like per runner argument);
        returns :meth:`stats` after the sweep."""
        with self._lock:
            items = list(self._runners.items())
        for tenant, runner in items:
            tmpl = templates.get(tenant)
            if tmpl is not None:
                runner.warmup(*tmpl)
        return self.stats()

    def stats(self) -> dict:
        """{"tenants": {tenant: runner stats}, "total_compiles",
        "total_hits"}: captures are what the fleet paid (once per (runner,
        bucket, spec)), hits are what each tenant's traffic reused."""
        with self._lock:
            items = list(self._runners.items())
        per = {t: r.stats() for t, r in items}
        return {"tenants": per,
                "total_compiles": sum(s["total_compiles"]
                                      for s in per.values()),
                "total_hits": sum(s["total_hits"] for s in per.values())}
