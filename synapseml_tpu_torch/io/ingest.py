"""The chunk pump: host → device ingestion for the streamed GBDT.

Counterpart of the JAX package's ``io/ingest.py``.

:class:`ChunkPump`
    A bounded-depth chunk pipeline. ``place(chunk)`` is applied to chunk
    ``k + 1`` while the consumer computes on chunk ``k``. Two drive modes:

    * ``threaded=False``: a synchronous lookahead deque (``depth`` chunks
      placed ahead of the one consumed);
    * ``threaded=True``: a named non-daemon producer thread pulls and places
      ahead of the consumer, so the host side of a transfer (reading a
      spilled chunk, filling a pinned buffer) overlaps compute too. The
      thread is joined on every exit path: ``__iter__`` closes the pump in a
      ``finally``, so a ``break``, an error or a preemption cannot leak it.

    Every chunk boundary is a :func:`core.checkpoint.preemption_point`
    (``phase``, ``step_base + k``), so a kill lands between chunks and the
    consumer's snapshot/resume contract applies; with an elastic watchdog
    installed (``parallel.elastic_watchdog``) it also beats there, with the
    phase (or the pump's name) as its op.

:class:`PinnedStager`
    How a chunk reaches the card: it is copied from the host cache into one
    of ``slots`` standing pinned buffers, a ``non_blocking`` copy runs on a
    side stream and an event is recorded; the consumer makes its compute
    stream wait on that event (:meth:`StagedChunk.wait`) before it reads the
    chunk. A pinned buffer is refilled only after its previous copy's event
    has completed, and the device buffer, allocated on the side stream, is
    marked used by the compute stream (``record_stream``), so the caching
    allocator cannot hand its memory out while compute still reads it. In a
    threaded producer the side stream is made current inside the thread.

:func:`pump_polling`
    The drain-poll skeleton: drive a destructive ``step()`` until ``stop`` is
    set, sleeping ``interval`` when idle. Not a lookahead pump: draining is
    destructive and must stay behind its own preemption point.

Chunk geometry (:func:`stream_chunk_rows` / :func:`stream_depth`) resolves an
explicit argument > the ``SYNAPSEML_TPU_STREAM_CHUNK_ROWS`` /
``SYNAPSEML_TPU_STREAM_DEPTH`` environment > one timed pinned 4 MiB copy to
the card (``_probe_h2d_bandwidth``, cached for the process in
``core.tuned``), capped by the ``SYNAPSEML_TPU_STREAM_MEM_BUDGET`` byte
budget. The JAX package also reads a tuned-defaults file recorded on TPUs;
the port does not (those numbers say nothing of this card). Without a card
the probe has nothing to time and the fallback of 65,536 rows holds.

Disk: :func:`read_chunk_file` (a spilled ``.npy`` chunk through ``mmap``) and
:class:`DiskChunkSource` (``.npy`` or raw rows, mapped read-only) route every
chunk they read through the disk fault hook, so a torn read or an EIO
surfaces where a real dying disk would.
"""

from __future__ import annotations

import mmap as _mmap
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

# Chunk fault hook for the chaos tests: called as hook(k, chunk) -> chunk on
# the producer side before placement, so an injected delay, truncation or
# kill takes the path a slow or dying source would.
_CHAOS_CHUNK_HOOK = None

# Disk fault hook: called as hook(k, arr) -> arr on every chunk read from
# disk (DiskChunkSource and the StreamedDataset cache_dir readback); apart
# from _CHAOS_CHUNK_HOOK so a disk fault does not fire twice. It may return a
# short array (a torn read) or raise OSError (EIO); both surface at the
# consumer.
_CHAOS_DISK_HOOK = None

_DONE = object()     # end-of-stream sentinel on the producer queue


class ChunkStreamError(RuntimeError):
    """The producer died mid-stream (the source or ``place`` raised);
    raised on the consumer side at the next chunk boundary."""


class ChunkPump:
    """Bounded-depth chunk pipeline over ``source``.

    ``source``: any iterable of host chunks. ``place``: chunk -> placed chunk
    (identity when None). ``depth``: chunks placed ahead of the one being
    consumed. ``phase``: when set, each boundary fires
    ``preemption_point(phase, step_base + k)``; ``step_base`` keeps the
    boundary steps monotonic across the many pumps of one training run.
    ``on_thread_start``: called once in the producer thread before its first
    pull (the CUDA stager makes its side stream current there)."""

    def __init__(self, source: Iterable, place: Optional[Callable] = None,
                 depth: int = 2, threaded: bool = False,
                 phase: Optional[str] = None, step_base: int = 0,
                 name: str = "ingest",
                 on_thread_start: Optional[Callable[[], None]] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = iter(source)
        self._place = place if place is not None else (lambda c: c)
        self.depth = int(depth)
        self.threaded = bool(threaded)
        self.phase = phase
        self.step_base = int(step_base)
        self.name = name
        self._on_thread_start = on_thread_start
        self.chunks_produced = 0     # pulled from the source
        self.chunks_consumed = 0     # yielded to the consumer
        self.wait_s = 0.0            # the consumer's wait for the producer
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # -- producer side ----------------------------------------------------
    def _pull(self):
        """One produce step: next source chunk → fault hook → place."""
        try:
            chunk = next(self._source)
        except StopIteration:
            return _DONE
        hook = _CHAOS_CHUNK_HOOK
        if hook is not None:
            chunk = hook(self.chunks_produced, chunk)
        # the consumer reads this count only after _DONE came through the
        # queue, whose put/get pair orders the two threads
        self.chunks_produced += 1
        return self._place(chunk)

    def _produce(self) -> None:
        try:
            if self._on_thread_start is not None:
                self._on_thread_start()
            while not self._stop.is_set():
                item = self._pull()
                if item is _DONE:
                    break
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            # published to the consumer by the _DONE put below
            self._err = e
        finally:
            # always deliver end-of-stream; close() drains meanwhile, so
            # this cannot block against a consumer that has gone
            while not self._stop.is_set():
                try:
                    self._q.put(_DONE, timeout=0.05)
                    break
                except queue.Full:
                    continue

    def _start(self) -> None:
        if self._thread is None and not self._closed:
            self._thread = threading.Thread(
                target=self._produce, name=f"chunk-pump.{self.name}")
            self._thread.start()

    def _sync_pull(self):
        """``_pull`` under the threaded mode's error contract: a failure of
        the source or of ``place`` is a :class:`ChunkStreamError` in both
        modes."""
        try:
            return self._pull()
        except BaseException as e:  # noqa: BLE001 — same contract as _produce
            raise ChunkStreamError(
                f"chunk producer {self.name!r} died at chunk "
                f"{self.chunks_produced}: {e!r}") from e

    # -- consumer side ----------------------------------------------------
    def _boundary(self) -> None:
        """Chunk boundary: preemption point and watchdog heartbeat."""
        step = self.step_base + self.chunks_consumed
        if self.phase is not None:
            from ..core.checkpoint import preemption_point

            preemption_point(self.phase, step)
        from ..parallel.elastic import current_watchdog

        wd = current_watchdog()
        if wd is not None:
            wd.beat(self.phase or self.name, step)

    def __iter__(self):
        try:
            if self.threaded:
                self._start()
                while True:
                    t0 = time.perf_counter()
                    item = self._q.get()
                    self.wait_s += time.perf_counter() - t0
                    if item is _DONE:
                        if self._err is not None:
                            raise ChunkStreamError(
                                f"chunk producer {self.name!r} died at chunk "
                                f"{self.chunks_produced}: {self._err!r}"
                            ) from self._err
                        return
                    self._boundary()
                    yield item
                    self.chunks_consumed += 1
            else:
                # refill before yielding, so the next placement is under way
                # while the consumer computes on the popped chunk
                q: deque = deque()
                while len(q) < self.depth:
                    item = self._sync_pull()
                    if item is _DONE:
                        break
                    q.append(item)
                while q:
                    out = q.popleft()
                    item = self._sync_pull()
                    if item is not _DONE:
                        q.append(item)
                    self._boundary()
                    yield out
                    self.chunks_consumed += 1
        finally:
            self.close()

    def close(self) -> None:
        """Stop the producer and join it (idempotent; every ``__iter__``
        exit path and ``__exit__`` call it). The queue is drained while
        joining, so a blocked ``put`` cannot wedge the join."""
        self._stop.set()
        t = self._thread
        while t is not None and t.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            t.join(0.05)
        self._thread = None
        self._closed = True

    def __enter__(self) -> "ChunkPump":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def pump_polling(step: Callable[[], bool], stop: threading.Event,
                 interval: float,
                 on_error: Optional[Callable[[Exception], None]] = None
                 ) -> None:
    """Drive a destructive drain ``step`` until ``stop`` is set.

    ``step() -> bool`` says whether it did work; an idle round waits
    ``interval`` on the stop event. An ``Exception`` from a step goes to
    ``on_error`` and the loop keeps draining; a ``BaseException`` (a
    ``PreemptionError``) ends the loop, as a real SIGTERM would."""
    while not stop.is_set():
        try:
            worked = step()
        except Exception as e:  # noqa: BLE001 — the loop outlives bad input
            if on_error is not None:
                on_error(e)
            worked = False
        if not worked:
            stop.wait(interval)


# ---------------------------------------------------------------------------
# Host → card staging through standing pinned buffers
# ---------------------------------------------------------------------------

_ALIGN = 256     # byte alignment of each array inside a staged chunk


class StagedChunk:
    """One chunk's arrays on the card, with the timing events of the copy
    that brought them; :meth:`wait` orders the current stream after it."""

    def __init__(self, arrays: List, ready, start):
        self.arrays = arrays
        self.ready = ready          # torch.cuda.Event after the copy
        self.start = start          # and before it
        self.waited_at = None       # compute-stream event at the wait

    def wait(self) -> List:
        """Make the current stream wait for the copy; returns the arrays.
        An event recorded on the current stream just before the wait lets
        :meth:`exposed_ms` say how long compute waited."""
        import torch

        stream = torch.cuda.current_stream()
        self.waited_at = torch.cuda.Event(enable_timing=True)
        self.waited_at.record(stream)
        stream.wait_event(self.ready)
        return self.arrays

    def copy_ms(self) -> float:
        """The copy's device time (both events must have completed)."""
        return self.start.elapsed_time(self.ready)

    def exposed_ms(self) -> float:
        """How long the compute stream waited on this copy: the copy's end
        past the moment compute reached the wait, or 0."""
        if self.waited_at is None:
            return 0.0
        return max(0.0, self.waited_at.elapsed_time(self.ready))


class PinnedStager:
    """``slots`` standing pinned host buffers of ``nbytes`` each and a side
    stream on ``device``: :meth:`stage` packs a chunk's numpy arrays into the
    next buffer and starts one ``non_blocking`` copy to the card on the side
    stream (module docstring), between two timing events. The device
    buffers are marked used by the stream current at construction, the
    consumer's compute stream."""

    def __init__(self, nbytes: int, slots: int, device):
        import torch

        dev = torch.device(device)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.nbytes = int(nbytes)
        self.bufs = [torch.empty(self.nbytes, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(int(slots))]
        self.events: list = [None] * len(self.bufs)
        self.side = torch.cuda.Stream(self.device)
        self.compute = torch.cuda.current_stream(self.device)
        self.k = 0

    def make_side_current(self) -> None:
        """For a producer thread: the side stream becomes that thread's
        current stream on the device."""
        import torch

        torch.cuda.set_device(self.device)
        torch.cuda.set_stream(self.side)

    def stage(self, arrays: Sequence[np.ndarray]) -> StagedChunk:
        import torch

        slot = self.k % len(self.bufs)
        self.k += 1
        prev = self.events[slot]
        if prev is not None:
            prev.synchronize()           # the buffer's last copy is done
        buf = self.bufs[slot]
        host = buf.numpy()
        spans, off = [], 0
        for a in arrays:
            a = np.ascontiguousarray(a)
            nb = a.nbytes
            if off + nb > self.nbytes:
                raise ValueError(f"chunk of {off + nb} bytes exceeds the "
                                 f"{self.nbytes}-byte pinned buffer")
            host[off:off + nb] = a.reshape(-1).view(np.uint8)
            spans.append((off, nb, a.dtype, a.shape))
            off = -(-(off + nb) // _ALIGN) * _ALIGN
        with torch.cuda.stream(self.side):
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.side)
            dev = buf[:max(off, 1)].to(self.device, non_blocking=True)
            ready = torch.cuda.Event(enable_timing=True)
            ready.record(self.side)
        # allocated on the side stream, read on the compute stream
        dev.record_stream(self.compute)
        self.events[slot] = ready
        out = []
        for o, nb, dt, shape in spans:
            tdt = torch.from_numpy(np.empty(0, dt)).dtype
            out.append(dev[o:o + nb].view(tdt).view(shape))
        return StagedChunk(out, ready, start)


# ---------------------------------------------------------------------------
# Chunk geometry: explicit > environment > measured probe
# ---------------------------------------------------------------------------

_PROBE_BYTES = 4 << 20         # one pinned 4 MiB copy prices the link
_TARGET_CHUNK_S = 8e-3         # a chunk is about 8 ms of transfer
_MIN_CHUNK_ROWS = 1024
_MAX_CHUNK_ROWS = 1 << 20
_FALLBACK_CHUNK_ROWS = 65536


def _probe_h2d_bandwidth() -> float:
    """Measured host → card bytes/s: one pinned 4 MiB copy, timed with CUDA
    events after a warm-up copy."""
    import torch

    buf = torch.zeros(_PROBE_BYTES, dtype=torch.uint8).pin_memory()
    dst = torch.empty(_PROBE_BYTES, dtype=torch.uint8, device="cuda")
    dst[:1024].copy_(buf[:1024], non_blocking=True)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    dst.copy_(buf, non_blocking=True)
    t1.record()
    t1.synchronize()
    dt = max(t0.elapsed_time(t1) / 1e3, 1e-9)
    return _PROBE_BYTES / dt


def _platform() -> Optional[str]:
    """``"cuda"`` when a card is present, else None (nothing to probe)."""
    import torch

    return "cuda" if torch.cuda.is_available() else None


def mem_budget_bytes() -> Optional[int]:
    """The device-memory cap for in-flight streamed chunks
    (``SYNAPSEML_TPU_STREAM_MEM_BUDGET``, bytes), or None."""
    v = os.environ.get("SYNAPSEML_TPU_STREAM_MEM_BUDGET")
    if not v:
        return None
    return max(int(v), 1)


_LAST_CHUNK_DECISION = None


def last_chunk_decision():
    """Provenance of the most recent probe-resolved chunk geometry
    (``core.perfmodel.suggest_chunk_rows``), or None when an explicit or
    environment value decided."""
    return _LAST_CHUNK_DECISION


def _perfmodel_chunk_rows(row_bytes: int, depth: int, fallback_rows: int,
                          h2d_bps) -> int:
    global _LAST_CHUNK_DECISION
    from ..core import perfmodel

    rows, dec = perfmodel.suggest_chunk_rows(
        row_bytes, int(depth), int(fallback_rows), h2d_bps=h2d_bps)
    _LAST_CHUNK_DECISION = dec.provenance()
    return int(rows)


def stream_chunk_rows(row_bytes: int, explicit: Optional[int] = None,
                      depth: int = 2,
                      read_bps: Optional[float] = None) -> int:
    """Rows per streamed chunk for rows of ``row_bytes`` each: ``explicit`` >
    ``SYNAPSEML_TPU_STREAM_CHUNK_ROWS`` > the probe (a chunk of about
    ``_TARGET_CHUNK_S`` of measured link time, clamped to
    [``_MIN_CHUNK_ROWS``, ``_MAX_CHUNK_ROWS``]; without a card the fallback
    of 65,536 rows). ``read_bps``, a disk source's measured read rate, is
    combined in series with the link (a chunk crosses disk → host, then
    host → card). Whatever decides is then capped so ``depth + 1`` chunks
    fit ``SYNAPSEML_TPU_STREAM_MEM_BUDGET`` when it is set."""
    from ..core import tuned as _tuned

    global _LAST_CHUNK_DECISION
    _LAST_CHUNK_DECISION = None   # set again only if the probe branch runs
    row_bytes = max(int(row_bytes), 1)
    rows = explicit
    if rows is None:
        env = os.environ.get("SYNAPSEML_TPU_STREAM_CHUNK_ROWS")
        if env:
            rows = int(env)
    if rows is None:
        plat = _platform()
        bw = None
        if plat is None:
            rows = _FALLBACK_CHUNK_ROWS
        else:
            bw = _tuned.measured_or(("h2d_bytes_per_s", plat),
                                    _probe_h2d_bandwidth)
            if read_bps:
                bw = 1.0 / (1.0 / bw + 1.0 / float(read_bps))
            rows = int(bw * _TARGET_CHUNK_S / row_bytes)
        # the clamp disciplines the probe only: an explicit or environment
        # value is the operator's and wins as given
        rows = min(max(rows, _MIN_CHUNK_ROWS), _MAX_CHUNK_ROWS)
        rows = _perfmodel_chunk_rows(row_bytes, depth, rows, bw)
    rows = max(int(rows), 1)
    budget = mem_budget_bytes()
    if budget is not None:
        cap = budget // (row_bytes * (int(depth) + 1))
        rows = max(min(rows, cap), 1)
    return rows


def stream_depth(explicit: Optional[int] = None) -> int:
    """Chunks in flight ahead of the consumer: ``explicit`` >
    ``SYNAPSEML_TPU_STREAM_DEPTH`` > 2 (double buffering)."""
    if explicit is not None:
        return max(int(explicit), 1)
    env = os.environ.get("SYNAPSEML_TPU_STREAM_DEPTH")
    if env:
        return max(int(env), 1)
    return 2


# ---------------------------------------------------------------------------
# Disk-backed chunks: mmap'd .npy / raw rows
# ---------------------------------------------------------------------------

def _disk_hook(k, arr):
    hook = _CHAOS_DISK_HOOK
    return arr if hook is None else hook(k, arr)


def _npy_header(f):
    """``(shape, dtype, data_offset)`` of an open ``.npy`` file (versions
    1.0 and 2.0, C order only: the layouts ``np.save`` writes)."""
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        raise ValueError(f"unsupported .npy format version {version}")
    if fortran:
        raise ValueError(".npy file is Fortran-ordered; the disk chunk "
                         "source needs C-order rows")
    return shape, dtype, f.tell()


def _probe_disk_bandwidth(path: str) -> float:
    """Disk → host bytes/s of ``path``'s file system: one sequential read
    of up to ``_PROBE_BYTES`` (an upper bound when the page cache is
    warm)."""
    n = min(os.path.getsize(path), _PROBE_BYTES)
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        f.read(max(int(n), 1))
    dt = max(time.perf_counter() - t0, 1e-9)
    return max(int(n), 1) / dt


def read_chunk_file(path: str, k: int = 0):
    """One whole spilled ``.npy`` chunk through ``mmap`` and the disk fault
    hook; a fresh host array, never a live view of the map."""
    with open(path, "rb") as f:
        shape, dtype, off = _npy_header(f)
        mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        flat = np.frombuffer(mm, dtype=dtype,
                             count=int(np.prod(shape)), offset=off)
        try:
            out = np.array(flat.reshape(shape))
        finally:
            # the frombuffer view holds the map: drop it before close()
            del flat
            mm.close()
    return _disk_hook(int(k), out)


class DiskChunkSource:
    """Memory-mapped on-disk rows, usable as ``StreamedDataset(batches=...)``:
    each call maps ``path`` read-only and yields ``(X, y, w)`` chunks of
    ``rows_per_chunk`` rows (``y`` / ``w`` None unless ``labels`` /
    ``weights`` were given). Layouts: ``.npy`` (a C-order 2-D array; its
    header gives shape and dtype) or, with ``raw=True``, headerless rows of
    ``num_features`` elements of ``dtype`` (default uint8). Each chunk is
    copied out of the map and passes the disk fault hook.
    ``read_bytes_per_s`` is a one-time sequential read probe, which
    ``StreamedDataset.prepare`` folds into the chunk geometry."""

    def __init__(self, path: str, rows_per_chunk: int = _FALLBACK_CHUNK_ROWS,
                 raw: bool = False, num_features: Optional[int] = None,
                 dtype=None, labels=None, weights=None):
        self.path = os.fspath(path)
        self.rows_per_chunk = max(int(rows_per_chunk), 1)
        self.raw = bool(raw)
        self.labels = labels
        self.weights = weights
        if self.raw:
            if num_features is None:
                raise ValueError("raw disk source needs num_features")
            self._dtype = np.dtype(dtype if dtype is not None else np.uint8)
            itemsize = self._dtype.itemsize * int(num_features)
            n = os.path.getsize(self.path) // itemsize
            self._shape = (int(n), int(num_features))
            self._offset = 0
        else:
            if num_features is not None or dtype is not None:
                raise ValueError("num_features/dtype are raw-layout knobs; "
                                 ".npy files carry their own header")
            with open(self.path, "rb") as f:
                shape, dt, off = _npy_header(f)
            if len(shape) != 2:
                raise ValueError(f".npy disk source must be 2-D (rows, "
                                 f"features), got shape {shape}")
            self._shape, self._dtype, self._offset = shape, dt, off
        self.n_rows, self.num_features = (int(self._shape[0]),
                                          int(self._shape[1]))
        self._read_bps: Optional[float] = None

    @property
    def read_bytes_per_s(self) -> float:
        if self._read_bps is None:
            from ..core import tuned as _tuned

            self._read_bps = float(_tuned.measured_or(
                ("disk_read_bytes_per_s", self.path),
                lambda: _probe_disk_bandwidth(self.path)))
        return self._read_bps

    def __call__(self):
        n, F, R = self.n_rows, self.num_features, self.rows_per_chunk
        f = open(self.path, "rb")
        try:
            mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
            flat = np.frombuffer(mm, dtype=self._dtype,
                                 count=n * F, offset=self._offset)
            arr = flat.reshape(n, F)
            try:
                for k, a in enumerate(range(0, n, R)):
                    X = _disk_hook(k, np.array(arr[a:a + R]))
                    c = int(X.shape[0])       # the hook may tear it short
                    sl = slice(a, a + c)
                    y = None if self.labels is None else self.labels[sl]
                    w = None if self.weights is None else self.weights[sl]
                    yield (X, y, w)
            finally:
                # every view of the map goes before close()
                del flat, arr
                mm.close()
        finally:
            f.close()
