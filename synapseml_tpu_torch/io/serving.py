"""Serving — embedded HTTP server feeding micro-batches through a handler.

The port's counterpart of the JAX package's ``io/serving.py``. A threaded
HTTP server queues requests, a serving loop drains the queue into a
``Table`` micro-batch, runs the user handler (typically one replay of a
captured CUDA graph per batch, through ``Booster.serving_fn()``), and
writes each row's reply back to its still-open connection — the
architecture of the reference's Spark Serving (a request queue and a reply
sink keyed by request id), without Spark.

Resilience model:

* **Bounded admission** — the request queue holds at most
  ``max_queue_size`` entries; overload is shed as an immediate 503 instead
  of growing latency without bound.
* **Deadline propagation** — a client ``X-Deadline-Ms`` header (remaining
  budget, capped by ``reply_timeout``) rides the request: the connection
  thread 504s at the deadline no matter what, and batch formation drops
  already-expired requests without spending handler time on them. Handlers
  that accept a ``budget=`` keyword receive the batch's remaining seconds.
* **Failure isolation** — a handler exception fails only the poisoned rows:
  the batch is retried row-by-row (``isolate_failures``) so one bad payload
  cannot 500 its co-batched neighbors.
* **Graceful drain** — ``stop()`` first refuses new work (503) while
  in-flight requests complete, then tears the server down.
* **Zero-downtime model hot-swap** — :class:`ModelRegistry` stages a new
  handler version (optionally loaded from a digest-verified
  ``core.checkpoint.CheckpointStore`` checkpoint), warms (captures) it off
  the hot path, and atomically flips the serving pointer; every request is
  pinned at admission to the handler version that accepted it, so a swap
  can never change the program answering an in-flight request, and a failed
  load/build/warmup rolls back with the old version never having stopped.
* **Multi-tenant isolation** — with a
  :class:`~synapseml_tpu_torch.core.qos.QoSController`, requests carry
  ``X-Tenant``; each tenant gets its own serving pointer + registry
  (``add_tenant``), its own admission contract (token bucket → 429,
  quarantine breaker → 503, bounded weighted-fair queue lane), and its own
  failure accounting — a tenant that floods, throws, or NaN-storms is shed
  at ITS boundary while other tenants' p99 and availability hold.

``ServingServer.metrics`` exposes queue depth/age gauges and shed/error/
deadline counters; the same events also land in the process-wide
``core.logging`` failure counters.

Throughput model:

* **Two-stage pipeline** — the serve loop only *forms* batches (deadline
  triage + Table assembly; the JSON decode already happened on the
  connection threads) and hands them to a dedicated executor thread through
  a depth-1 handoff, so batch N+1's formation overlaps batch N's
  handler/device execution and reply encoding.
* **Blocking batch window** — batch formation waits on
  ``queue.get(timeout=remaining_window)`` instead of a sleep/poll spin: no
  burned CPU inside the window and less jitter at low load.
* **Shape-bucketed handlers** — a handler built on
  :class:`~synapseml_tpu_torch.core.inference.BucketedRunner` (e.g.
  ``Booster.serving_fn()``) captures one CUDA graph per bucket instead of
  running every operation of the model as its own launch; ``start()``
  invokes the handler's ``warmup()`` (when it has one) so every bucket is
  captured before the first request, and the metrics GET surfaces the
  runner's per-bucket capture/hit counters under ``"runner"``.
"""

from __future__ import annotations

import json as _json
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.logging import record_failure
from ..core.qos import (DEFAULT_TENANT, TENANT_HEADER, QoSController,
                        WeightedFairQueue)
from ..core.resilience import DEADLINE_HEADER, Deadline
from ..core.table import Table


@dataclass
class _PendingRequest:
    """CachedRequest analog (HTTPSourceV2.scala:530-539)."""
    id: str
    method: str
    path: str
    headers: Dict[str, str]
    body: bytes
    reply_event: threading.Event = field(default_factory=threading.Event)
    response: Optional[tuple] = None  # (status, headers, body)
    deadline: Optional[Deadline] = None
    admitted_at: float = 0.0          # monotonic enqueue time (queue age)
    # the handler VERSION this request was admitted under (hot-swap pinning:
    # a model swap mid-flight must not change the program that answers an
    # already-accepted request). None -> whatever is active at batch time.
    handler: Optional[Callable] = None
    # X-Tenant this request was admitted under: pins (tenant, version) so a
    # per-tenant swap stays atomic per tenant, routes the request through
    # its tenant's WeightedFairQueue lane, and keys outcome feedback to the
    # tenant's own QoS breaker
    tenant: str = DEFAULT_TENANT


class ServingMetrics:
    """Thread-safe counters + gauges for one server (the queue-depth/age and
    shed/error observability the resilience tests assert on)."""

    _COUNTERS = ("accepted", "shed", "drain_rejected", "completed",
                 "handler_errors", "isolated_rows", "deadline_dropped",
                 "deadline_expired", "batches")

    def __init__(self, queue_ref: "queue.Queue"):
        self._q = queue_ref
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self._COUNTERS}
        self.last_batch_size = 0
        self.last_queue_age_s = 0.0   # oldest-request age at batch formation

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def observe_batch(self, size: int, oldest_age_s: float) -> None:
        with self._lock:
            self._c["batches"] += 1
            self.last_batch_size = size
            self.last_queue_age_s = oldest_age_s

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._c[name]

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            out["queue_depth"] = self._q.qsize()
            out["last_batch_size"] = self.last_batch_size
            out["last_queue_age_s"] = round(self.last_queue_age_s, 6)
        return out


def request_to_table(requests: List[_PendingRequest]) -> Table:
    """Micro-batch of queued requests → Table(id, value) — the serving source
    schema (id + request struct)."""
    ids = np.array([r.id for r in requests], dtype=object)
    vals = np.empty(len(requests), dtype=object)
    for i, r in enumerate(requests):
        try:
            vals[i] = _json.loads(r.body.decode()) if r.body else None
        except Exception:
            vals[i] = r.body
    return Table({"id": ids, "value": vals})


def respond_with(df: Table, id_col: str = "id", value_col: str = "reply",
                 status_col: Optional[str] = None) -> Dict[str, tuple]:
    """Table → {request id: (status, body)} — the reply-UDF analog
    (ServingUDFs.scala makeReplyUDF).

    Column lookups are hoisted out of the per-row loop, and homogeneous
    numeric reply columns take a single vectorized ``tolist()`` pass (one
    device→host materialization + one bulk conversion) instead of per-row
    numpy indexing + scalar boxing — the reply-encode side of the serving
    hot path."""
    ids = df[id_col].tolist()
    col = df[value_col]
    n = df.num_rows
    if status_col and status_col in df:
        statuses = [int(s) for s in df[status_col].tolist()]
    else:
        statuses = None
    if col.dtype != object:
        # homogeneous numeric/bool column (scalar or fixed-width vector
        # replies): one bulk pass yields plain Python values json.dumps
        # takes directly
        vals = col.tolist()
    else:
        vals = []
        for v in col:
            if isinstance(v, np.ndarray):
                v = v.tolist()
            elif isinstance(v, np.generic):
                v = v.item()
            vals.append(v)
    out = {}
    dumps = _json.dumps
    for i in range(n):
        status = statuses[i] if statuses is not None else 200
        out[str(ids[i])] = (status, dumps(vals[i]).encode())
    return out


class ServingServer:
    """spark.readStream.server()...writeStream.server() analog.

    ``handler``: Table(id, value) -> Table(id, reply) — typically a fitted
    PipelineModel wrapped to map columns. Batching: requests are collected for
    up to ``maxBatchLatency`` seconds or ``maxBatchSize`` rows, whichever
    first (micro-batch trigger analog), then run through the handler as ONE
    batch — with a bucketed handler, one graph replay on the card, which is
    where the reference's "sub-millisecond" story becomes a
    batched-throughput story.

    A handler may declare a ``budget`` keyword parameter to receive the
    batch's remaining deadline budget in seconds (None when every request in
    the batch is deadline-less).
    """

    def __init__(self, handler: Callable[[Table], Table],
                 host: str = "127.0.0.1", port: int = 8898,
                 api_path: str = "/", max_batch_size: int = 64,
                 max_batch_latency: float = 0.005,
                 reply_timeout: float = 30.0,
                 max_queue_size: int = 1024,
                 isolate_failures: bool = True,
                 drain_timeout: float = 10.0,
                 warmup: bool = True,
                 qos: Optional[QoSController] = None):
        self.handler = handler
        self.host, self.port = host, port
        self.api_path = api_path
        self.max_batch_size = max_batch_size
        self.max_batch_latency = max_batch_latency
        self.reply_timeout = reply_timeout
        self.max_queue_size = max_queue_size
        self.isolate_failures = isolate_failures
        self.drain_timeout = drain_timeout
        self.warmup = warmup
        self.registry: Optional["ModelRegistry"] = None  # hot-swap registry
        # multi-tenant mode: per-tenant serving pointers + registries keyed
        # by X-Tenant; ``handler`` stays the default-tenant fallback so a
        # single-tenant server is the degenerate case of the same machinery
        self.qos = qos
        self.tenant_handlers: Dict[str, Callable] = {}
        self.registries: Dict[str, "ModelRegistry"] = {}
        if qos is not None:
            # per-tenant bounded lanes + weighted-fair dequeue; same
            # queue.Queue surface, so the pipeline above is unchanged
            self._queue = WeightedFairQueue(maxsize=max_queue_size, qos=qos)
        else:
            self._queue: "queue.Queue[_PendingRequest]" = queue.Queue(
                maxsize=max_queue_size)
        # two-stage pipeline handoff (batch formation → execution): depth 1
        # lets the serve loop form batch N+1 while the executor runs batch N
        self._handoff: "queue.Queue" = queue.Queue(maxsize=1)
        self.metrics = ServingMetrics(self._queue)
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._idle = threading.Event()   # no batch forming/queued/executing
        self._idle.set()
        self._inflight_stages = 0        # guarded by _stage_lock
        self._stage_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []
        # budget-kwarg detection is per HANDLER (hot-swap can install a new
        # one at any time); keyed by id() with the handler kept alive in the
        # value so a recycled id can never alias a dead handler's signature
        self._budget_sig: Dict[int, tuple] = {}

    def _takes_budget(self, handler: Callable) -> bool:
        hit = self._budget_sig.get(id(handler))
        if hit is not None and hit[0] is handler:
            return hit[1]
        try:
            import inspect

            takes = "budget" in inspect.signature(handler).parameters
        except (TypeError, ValueError):
            takes = False
        self._budget_sig[id(handler)] = (handler, takes)
        return takes

    # --- multi-tenant surface ------------------------------------------
    def handler_for(self, tenant: str) -> Callable:
        """Active serving pointer for a tenant (default-tenant fallback:
        ``self.handler``) — the per-tenant analog of ``self.handler``, read
        once at admission to pin (tenant, version)."""
        return self.tenant_handlers.get(tenant, self.handler)

    def add_tenant(self, tenant: str, handler: Callable,
                   qos_class=None, version: str = "v0",
                   warmup: Optional[bool] = None) -> "ModelRegistry":
        """Register a tenant: its serving pointer, its own hot-swap
        :class:`ModelRegistry`, and (when the server is QoS-enabled) its
        admission contract. Warms the handler's bucket ladder unless the
        server was built with ``warmup=False``."""
        if qos_class is not None and self.qos is not None:
            self.qos.assign(tenant, qos_class)
        warm = getattr(handler, "warmup", None)
        if (self.warmup if warmup is None else warmup) and callable(warm):
            warm()
        self.tenant_handlers[tenant] = handler
        return ModelRegistry(self, version=version, tenant=tenant)

    def tenant_snapshot(self) -> dict:
        """Per-tenant observability: active version + swap history and the
        tenant handler's BucketedRunner capture/hit counters — the
        per-tenant accounting over the runners of the server."""
        out = {}
        for tenant, handler in self.tenant_handlers.items():
            entry: dict = {}
            reg = self.registries.get(tenant)
            if reg is not None:
                entry["model"] = reg.snapshot()
            runner = getattr(handler, "runner", None)
            if runner is not None and callable(getattr(runner, "stats",
                                                       None)):
                entry["runner"] = runner.stats()
            out[tenant] = entry
        return out

    # --- embedded server (WorkerServer analog) -------------------------
    def _make_handler_class(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: clients reuse the connection (and this
            # handler's thread) across requests instead of paying TCP setup +
            # thread spawn per request — the dominant term at sub-ms latencies
            protocol_version = "HTTP/1.1"
            # response headers+body go out in several small writes; without
            # TCP_NODELAY, Nagle + delayed ACK stalls each reply ~40 ms
            disable_nagle_algorithm = True
            # bound idle keep-alive connections: without a socket timeout each
            # idle client pins its handler thread in readline() forever and
            # stop() cannot quiesce them (timeout → close_connection)
            timeout = 30

            def _reply_error(self, status: int, body: bytes = b"",
                             retry_after: Optional[int] = None):
                self.send_response(status)
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                if body:
                    self.send_header("Content-Type", "application/json")
                # explicit Content-Length always: HTTP/1.1 keep-alive clients
                # block on a missing one
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def do_POST(self):  # noqa: N802
                if "chunked" in self.headers.get("Transfer-Encoding",
                                                 "").lower():
                    # chunked bodies are not parsed; reading 0 bytes would
                    # desync the keep-alive stream (the chunk data would be
                    # parsed as the next request), so reject and close
                    self._reply_error(411)  # Length Required
                    self.close_connection = True
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                # admission control BEFORE queueing: a draining/stopped
                # server refuses new work fast instead of letting it ride
                # into a queue nobody will drain
                if outer._draining.is_set() or outer._stop.is_set():
                    outer.metrics.incr("drain_rejected")
                    record_failure("serving.drain_rejected")
                    self._reply_error(
                        503, b'{"error": "server is draining"}',
                        retry_after=1)
                    return
                tenant = (self.headers.get(TENANT_HEADER)
                          or DEFAULT_TENANT).strip() or DEFAULT_TENANT
                if outer.qos is not None:
                    # per-tenant QoS boundary: a quarantined tenant sheds
                    # at ITS 503, a rate-limited one at ITS 429 — neither
                    # touches the shared queue or another tenant's budget
                    decision = outer.qos.admit(tenant)
                    if not decision.ok:
                        outer.metrics.incr("shed")
                        self._reply_error(
                            decision.status,
                            _json.dumps({"error": decision.reason,
                                         "tenant": tenant}).encode(),
                            retry_after=1)
                        return
                deadline = Deadline.from_header_ms(
                    self.headers.get(DEADLINE_HEADER),
                    outer.reply_timeout)
                req = _PendingRequest(
                    id=uuid.uuid4().hex, method="POST", path=self.path,
                    headers=dict(self.headers), body=body,
                    deadline=deadline, admitted_at=time.monotonic(),
                    # pin the ACTIVE (tenant, version) at admission: a
                    # model hot-swap between now and batch execution must
                    # not change the program answering this request, and a
                    # swap of tenant A must never touch tenant B's pin
                    handler=outer.handler_for(tenant),
                    tenant=tenant)
                try:
                    outer._queue.put_nowait(req)
                except queue.Full:
                    # load shedding: bounded queue + immediate 503 — the
                    # overload contract (fast rejection, not slow timeout).
                    # Under QoS the bound is the TENANT's own lane, so a
                    # flooding tenant sheds here while others keep landing
                    outer.metrics.incr("shed")
                    record_failure("serving.shed")
                    self._reply_error(
                        503, b'{"error": "server overloaded"}',
                        retry_after=1)
                    return
                outer.metrics.incr("accepted")
                if not req.reply_event.wait(deadline.remaining()):
                    # deadline breach: bounded-latency 504 even if the
                    # handler is wedged — the connection never hangs past
                    # the request's budget
                    outer.metrics.incr("deadline_expired")
                    record_failure("serving.deadline_expired")
                    self._reply_error(504)
                    return
                status, headers, payload = req.response
                self.send_response(status)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):  # noqa: N802  — metrics/health endpoint
                snap = {"draining": outer._draining.is_set(),
                        **outer.metrics.snapshot()}
                # a BucketedRunner-backed handler surfaces its per-bucket
                # capture/hit counters (zero steady-state captures after
                # warmup is the serving perf contract)
                runner = getattr(outer.handler, "runner", None)
                if runner is not None and callable(
                        getattr(runner, "stats", None)):
                    snap["runner"] = runner.stats()
                if outer.registry is not None:
                    snap["model"] = outer.registry.snapshot()
                if outer.qos is not None:
                    snap["qos"] = outer.qos.snapshot()
                if outer.tenant_handlers:
                    snap["tenants"] = outer.tenant_snapshot()
                body = _json.dumps(snap).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet
                pass

        return Handler

    # --- micro-batch serve loop ----------------------------------------
    def _run_batch(self, batch: List[_PendingRequest]) -> None:
        now = time.monotonic()
        # batch-formation deadline check: an expired request gets its 504
        # here and never costs handler time (its connection thread has
        # usually already answered; setting the response is idempotent)
        live: List[_PendingRequest] = []
        for r in batch:
            if r.deadline is not None and r.deadline.expired():
                r.response = (504, {}, b'{"error": "deadline exceeded"}')
                r.reply_event.set()
                self.metrics.incr("deadline_dropped")
                record_failure("serving.deadline_dropped")
            else:
                live.append(r)
        if not live:
            return
        oldest = min(r.admitted_at for r in live)
        self.metrics.observe_batch(len(live), now - oldest)
        budgets = [r.deadline.remaining() for r in live
                   if r.deadline is not None]
        budget = min(budgets) if budgets else None
        # hot-swap pinning: a batch formed across a swap boundary (or
        # across tenants) mixes requests admitted under different handlers
        # — each group runs through the handler it was admitted under, in
        # admission order within the group. Unlike the JAX package, which
        # starts a group at every change of handler, the port groups all of
        # a handler's requests of the batch into one call: weighted-fair
        # dequeue interleaves tenants request by request, and one call per
        # run would score each tenant's model several times per batch
        # (replies go by request id, so the order of groups is free)
        groups: Dict[int, tuple] = {}
        for r in live:
            h = r.handler if r.handler is not None else self.handler
            groups.setdefault(id(h), (h, []))[1].append(r)
        replies: Dict[str, tuple] = {}
        for h, group in groups.values():
            replies.update(self._call_handler(group, budget, h))
        by_id = {r.id: r for r in live}
        for rid, (status, payload) in replies.items():
            req = by_id.get(rid)
            if req is None:
                continue
            if (self.qos is not None and status == 200
                    and (b"NaN" in payload or b"Infinity" in payload)):
                # NaN-storm guard: json.dumps emits literal NaN/Infinity
                # for non-finite floats — a corrupted model must fail at
                # ITS tenant's 500 boundary (feeding its quarantine
                # breaker), not hand garbage to the client
                status = 500
                payload = _json.dumps(
                    {"error": "non-finite model output"}).encode()
                replies[rid] = (status, payload)
                record_failure("serving.nonfinite_reply",
                               tenant=req.tenant)
            req.response = (status, {}, payload)
            req.reply_event.set()
        # requests the handler dropped get an error instead of a hang
        for r in live:
            if r.response is None:
                r.response = (500, {}, b'{"error": "no reply produced"}')
                r.reply_event.set()
        if self.qos is not None:
            self._feed_qos(live, replies)
        self.metrics.incr("completed", len(live))

    def _feed_qos(self, live: List[_PendingRequest],
                  replies: Dict[str, tuple]) -> None:
        """Feed batch outcomes back to the per-tenant breakers: 5xx rows
        (handler throw, isolation failure, non-finite reply) count against
        THEIR tenant only; successes close that tenant's breaker."""
        ok: Dict[str, int] = {}
        bad: Dict[str, List[bool]] = {}
        for r in live:
            status, payload = replies.get(
                r.id, (r.response[0] if r.response else 500, b""))
            if status >= 500:
                bad.setdefault(r.tenant, []).append(
                    b"non-finite" in payload)
            else:
                ok[r.tenant] = ok.get(r.tenant, 0) + 1
        for tenant, n in ok.items():
            self.qos.record_success(tenant, n)
        for tenant, flags in bad.items():
            nonfinite = [f for f in flags if f]
            finite = [f for f in flags if not f]
            if finite:
                self.qos.record_failure(tenant, len(finite))
            if nonfinite:
                self.qos.record_failure(tenant, len(nonfinite),
                                        nonfinite=True)

    def _invoke(self, df: Table, budget: Optional[float],
                handler: Optional[Callable] = None):
        handler = self.handler if handler is None else handler
        if self._takes_budget(handler):
            return handler(df, budget=budget)
        return handler(df)

    def _call_handler(self, batch: List[_PendingRequest],
                      budget: Optional[float],
                      handler: Optional[Callable] = None) -> Dict[str, tuple]:
        df = request_to_table(batch)
        try:
            out = self._invoke(df, budget, handler)
            return respond_with(out) if isinstance(out, Table) else out
        except Exception as e:  # noqa: BLE001
            self.metrics.incr("handler_errors")
            record_failure("serving.handler_error", error=type(e).__name__)
            if not self.isolate_failures or len(batch) == 1:
                err = _json.dumps({"error": str(e)}).encode()
                return {r.id: (500, err) for r in batch}
        # failure isolation: rerun row-by-row so one poisoned payload fails
        # alone instead of 500ing the whole micro-batch
        replies: Dict[str, tuple] = {}
        for r in batch:
            try:
                out = self._invoke(request_to_table([r]), budget, handler)
                one = respond_with(out) if isinstance(out, Table) else out
                replies[r.id] = one.get(
                    r.id, (500, b'{"error": "no reply produced"}'))
            except Exception as e:  # noqa: BLE001
                self.metrics.incr("isolated_rows")
                record_failure("serving.isolated_row",
                               error=type(e).__name__)
                replies[r.id] = (500, _json.dumps(
                    {"error": str(e)}).encode())
        return replies

    # two-stage idle accounting: _idle is set only when no stage holds work
    # (forming, queued in the handoff, or executing) — drain() relies on it
    def _stage_enter(self) -> None:
        with self._stage_lock:
            self._inflight_stages += 1
            self._idle.clear()

    def _stage_exit(self) -> None:
        with self._stage_lock:
            self._inflight_stages -= 1
            if self._inflight_stages == 0:
                self._idle.set()

    def _serve_loop(self) -> None:
        """Stage 1 — micro-batch formation: drain queue → batch → handoff.

        Execution happens on the dedicated stage-2 thread (_exec_loop), so
        forming batch N+1 (queue drain + deadline triage; the JSON decode /
        ``np`` assembly follows in request_to_table) overlaps batch N's
        handler/device execution and reply encoding."""
        while True:
            batch: List[_PendingRequest] = []
            try:
                batch.append(self._queue.get(timeout=0.05))
            except queue.Empty:
                if self._stop.is_set():
                    self._handoff.put(None)   # release stage 2, then exit
                    return          # stopped AND queue drained: loop exits
                continue
            self._stage_enter()     # forming
            try:
                # drain the existing backlog for free (batching under load
                # costs no latency), then wait out the remaining
                # batch-formation window BLOCKED on the queue (no poll spin:
                # batch formation costs no CPU and no sleep-quantum jitter)
                deadline = time.monotonic() + self.max_batch_latency
                while len(batch) < self.max_batch_size:
                    try:
                        batch.append(self._queue.get_nowait())
                        continue
                    except queue.Empty:
                        pass
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._queue.get(timeout=remaining))
                    except queue.Empty:
                        break       # window elapsed with no new arrivals
                self._stage_enter()           # batch now owned by stage 2
                self._handoff.put(batch)
            finally:
                self._stage_exit()  # formation done

    def _exec_loop(self) -> None:
        """Stage 2 — execution: handoff → handler → reply by id."""
        while True:
            batch = self._handoff.get()
            if batch is None:
                return
            try:
                self._run_batch(batch)
            finally:
                self._stage_exit()

    def start(self) -> "ServingServer":
        class _Server(ThreadingHTTPServer):
            # default backlog of 5 resets connections under concurrent load
            request_queue_size = 256
            daemon_threads = True

        # warmup BEFORE the listener opens: a BucketedRunner-backed
        # handler (Booster.serving_fn()) captures its whole bucket ladder
        # here, so no request ever waits on a graph capture
        warm = getattr(self.handler, "warmup", None)
        if self.warmup and callable(warm):
            warm()
        self._httpd = _Server((self.host, self.port),
                              self._make_handler_class())
        self.port = self._httpd.server_address[1]  # resolve port 0
        t1 = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t2 = threading.Thread(target=self._serve_loop, daemon=True)
        t3 = threading.Thread(target=self._exec_loop, daemon=True)
        t1.start()
        t2.start()
        t3.start()
        self._threads = [t1, t2, t3]
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Refuse new requests (503) and wait until the queue is empty and
        the serve loop is idle. Returns True when fully drained."""
        self._draining.set()
        deadline = time.monotonic() + (self.drain_timeout
                                       if timeout is None else timeout)
        while time.monotonic() < deadline:
            if self._queue.empty() and self._idle.is_set():
                return True
            time.sleep(0.005)
        return self._queue.empty() and self._idle.is_set()

    def stop(self, drain: bool = True,
             drain_timeout: Optional[float] = None) -> None:
        """Graceful by default: in-flight requests complete (new ones get
        503 while draining), then the serve loop and listener shut down.
        ``drain=False`` tears down immediately — queued requests get their
        504 from their own deadline."""
        if drain and not self._stop.is_set():
            self.drain(drain_timeout)
        self._stop.set()
        # join stage 1 (which releases stage 2 via the None sentinel), then
        # stage 2; both are daemons, so a wedged handler cannot block exit
        for t in self._threads[1:]:
            if t.is_alive():
                t.join(timeout=1.0)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}{self.api_path}"

    def __enter__(self) -> "ServingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# --- zero-downtime model hot-swap -----------------------------------------
# Swap-point hook: the registry calls _swap_point(stage, version) at every
# state transition; normally a no-op, a fault-injection test installs a
# killer here so "die at any swap stage, old version never stops serving"
# is a CI property instead of a hope.

_SWAP_HOOK: Optional[Callable[[str, str], None]] = None


def _swap_point(stage: str, version: str) -> None:
    hook = _SWAP_HOOK
    if hook is not None:
        hook(stage, version)


class SwapError(RuntimeError):
    """A model swap failed (bad checkpoint, builder error, warmup failure,
    injected kill). The previously active version is still serving —
    raising this never interrupts traffic."""


class ModelRegistry:
    """Versioned handler registry driving zero-downtime hot-swap for one
    :class:`ServingServer`.

    Swap state machine::

        idle -> load -> build -> warmup -> flip -> done
                  \\        \\        \\
                   +--------+--------+--> rolled_back (old version serving)

    * ``load`` — read + digest-verify the checkpoint from a
      :class:`~synapseml_tpu_torch.core.checkpoint.CheckpointStore` (a corrupt or
      torn checkpoint fails HERE, via the store's manifest verification).
    * ``build`` — ``builder(checkpoint) -> handler`` constructs the new
      version's handler (model deserialization, runner construction).
    * ``warmup`` — the new handler's bucket ladder is captured OFF the hot
      path (the old version keeps serving throughout; this is the expensive
      stage and it costs traffic nothing).
    * ``flip`` — one atomic assignment of the server's serving pointer.
      Requests admitted before the flip are PINNED to the old handler
      (``_PendingRequest.handler``) and complete on it; requests admitted
      after run the new version. No drain, no gap, no 5xx.

    A failure (or injected kill) at load/build/warmup rolls back: the flip
    never happened, the old version never stopped serving, and the attempt
    is recorded (``swap_failures``, ``serving.swap_failed`` counter). A kill
    AFTER the flip leaves the new version serving — either side of the flip
    is a consistent fabric.

    Old versions stay registered (instant :meth:`rollback`); :meth:`retire`
    drops one after waiting for the server's in-flight stages to go idle —
    the drain machinery's idle accounting, reused so a retire can never
    yank a handler out from under a pinned in-flight batch.

    **Multi-tenant mode** (``tenant=...``): the registry drives ONE tenant's
    serving pointer (``server.tenant_handlers[tenant]``) instead of the
    server-wide ``server.handler`` — each tenant gets its own registry, its
    own version history, and its own atomic flip; admission pins
    ``handler_for(tenant)``, so tenant A's swap can never change the program
    answering tenant B's in-flight (or future) requests.

    **Swap concurrency**: two racing promoters are resolved by a
    non-blocking swap lock with a deterministic loser — the second caller
    gets ``SwapError("swap in progress")`` immediately instead of queueing
    behind (and then blindly overwriting) the first. The lock is reentrant
    so :meth:`swap_from_store` can delegate to :meth:`swap_to`, and so the
    two-phase :meth:`prepare`/:meth:`commit` pair (promotion broadcast)
    holds it across the prepare window — a racing single-shot swap loses to
    an in-flight broadcast the same deterministic way.
    """

    def __init__(self, server: ServingServer,
                 version: str = "v0", keep_versions: int = 3,
                 tenant: Optional[str] = None):
        if keep_versions < 2:
            raise ValueError("keep_versions must be >= 2 (active + rollback)")
        self.server = server
        self.keep_versions = keep_versions
        self.tenant = tenant
        self._lock = threading.Lock()       # registry state
        # one swap at a time, non-blocking acquire (deterministic loser);
        # reentrant: swap_from_store -> swap_to and prepare -> commit run
        # on one owning thread
        self._swap_lock = threading.RLock()
        self._staged: Optional[tuple] = None   # (version, handler) prepared
        # the thread holding the swap lock across a prepare window — read
        # by take_over_staged to prove the coordinator is DEAD before a
        # surviving peer adopts its orphaned stage
        self._swap_owner: Optional[threading.Thread] = None
        initial = (server.handler if tenant is None
                   else server.handler_for(tenant))
        self.versions: Dict[str, Callable] = {version: initial}
        self.active = version
        self.history: List[str] = [version]
        self.swaps = 0
        self.swap_failures = 0
        self.last_error: Optional[str] = None
        if tenant is None:
            server.registry = self
        else:
            server.tenant_handlers.setdefault(tenant, initial)
            server.registries[tenant] = self

    def _acquire_swap(self) -> None:
        if not self._swap_lock.acquire(blocking=False):
            record_failure("serving.swap_conflict", tenant=self.tenant)
            raise SwapError("swap in progress")
        with self._lock:
            self._swap_owner = threading.current_thread()
        if self._staged is not None:
            # the lock is reentrant (prepare -> commit on one thread), so a
            # same-thread single-shot swap racing an open prepare window
            # acquires — it must still lose deterministically
            self._swap_lock.release()
            record_failure("serving.swap_conflict", tenant=self.tenant)
            raise SwapError("swap in progress")

    def _install(self, handler: Callable) -> None:
        """The flip itself: one atomic assignment of this registry's
        serving pointer (tenant-scoped in multi-tenant mode)."""
        if self.tenant is None:
            self.server.handler = handler
        else:
            self.server.tenant_handlers[self.tenant] = handler

    # -- swap pipeline --
    def swap_to(self, version: str, handler: Callable,
                warmup: bool = True) -> str:
        """Stage ``handler`` as ``version``, warm it off the hot path, and
        atomically flip the server to it. Raises :class:`SwapError` on any
        pre-flip failure (old version still serving). Returns ``version``."""
        self._acquire_swap()
        try:
            # only Exception-derived faults roll back: PreemptionError is
            # BaseException on purpose (a real SIGTERM kills the process,
            # it does not roll back a swap)
            try:
                _swap_point("build", version)
                warm = getattr(handler, "warmup", None)
                if warmup and callable(warm):
                    _swap_point("warmup", version)
                    warm()          # old version serves during the capture
                _swap_point("flip", version)
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self.swap_failures += 1
                    self.last_error = f"{type(e).__name__}: {e}"
                record_failure("serving.swap_failed", version=version,
                               stage="pre-flip", error=type(e).__name__)
                raise SwapError(
                    f"swap to {version!r} failed before the flip "
                    f"({type(e).__name__}: {e}); "
                    f"{self.active!r} is still serving") from e
            # the flip: one atomic pointer assignment — admission pins the
            # handler per request, so either side of this line is consistent
            self._record_flip(version, handler)
            record_failure("serving.swap_completed", version=version)
            _swap_point("done", version)
            self._prune()
            return version
        finally:
            self._swap_lock.release()

    def _record_flip(self, version: str, handler: Callable) -> None:
        with self._lock:
            self.versions[version] = handler
            self.active = version
            if version in self.history:
                self.history.remove(version)
            self.history.append(version)
            self.swaps += 1
            self.last_error = None
        self._install(handler)

    # -- two-phase swap (promotion broadcast) --
    def prepare(self, version: str, handler: Callable,
                warmup: bool = True) -> str:
        """Phase 1 of a fabric-wide swap: stage + warm ``handler`` OFF
        the hot path and hold the swap lock, WITHOUT flipping. The old
        version keeps serving; a racing swap loses with
        ``SwapError("swap in progress")``. Follow with :meth:`commit` (the
        atomic flip) or :meth:`abort` (discard, old version untouched) —
        from the same thread (the lock is owned by it)."""
        self._acquire_swap()
        try:
            _swap_point("prepare", version)
            warm = getattr(handler, "warmup", None)
            if warmup and callable(warm):
                _swap_point("warmup", version)
                warm()
        except Exception as e:  # noqa: BLE001
            self._swap_lock.release()
            with self._lock:
                self.swap_failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
            record_failure("serving.swap_failed", version=version,
                           stage="prepare", error=type(e).__name__)
            raise SwapError(
                f"prepare of {version!r} failed "
                f"({type(e).__name__}: {e}); "
                f"{self.active!r} is still serving") from e
        self._staged = (version, handler)
        return version

    def commit(self, version: Optional[str] = None) -> str:
        """Phase 2: atomically flip to the prepared version and release the
        swap lock. A failure AT the commit point (injected kill) leaves the
        version staged and the lock held — :meth:`commit` may be retried,
        or :meth:`abort` discards. Without a matching :meth:`prepare` this
        raises :class:`SwapError`."""
        staged = self._staged
        if staged is None:
            raise SwapError("commit without a prepared version")
        staged_version, handler = staged
        if version is not None and version != staged_version:
            raise SwapError(
                f"commit of {version!r} but {staged_version!r} is staged")
        _swap_point("commit", staged_version)   # fault-injection point
        self._record_flip(staged_version, handler)
        self._staged = None
        self._swap_lock.release()
        record_failure("serving.swap_completed", version=staged_version)
        _swap_point("done", staged_version)
        self._prune()
        return staged_version

    def take_over_staged(self) -> bool:
        """Adopt an orphaned prepare window after its coordinator died.

        A prepare holds the swap RLock in the COORDINATOR's thread; if that
        thread dies mid-broadcast the stage is stranded — an RLock can
        never be released by another thread, so a surviving peer could
        neither :meth:`commit` nor :meth:`abort`. This transfers ownership:
        only when the owning thread is provably dead (``is_alive()`` is
        False), the abandoned lock object is REPLACED with a fresh one
        acquired by the caller, who may then drive the staged version to
        commit or abort exactly as the coordinator would have. A live
        owner raises :class:`SwapError` — takeover is recovery, never
        preemption. Returns False when nothing is staged (the coordinator
        finished or never prepared here); True when the caller now owns
        the stage (idempotent for the owner itself)."""
        with self._lock:
            staged = self._staged
            owner = self._swap_owner
        if staged is None:
            return False
        if owner is threading.current_thread():
            return True
        if owner is not None and owner.is_alive():
            raise SwapError(
                f"staged swap to {staged[0]!r} is owned by live thread "
                f"{owner.name!r}; takeover requires a dead coordinator")
        fresh = threading.RLock()
        fresh.acquire()
        with self._lock:
            self._swap_lock = fresh
            self._swap_owner = threading.current_thread()
        record_failure("serving.swap_takeover", version=staged[0],
                       tenant=self.tenant)
        return True

    def abort(self) -> bool:
        """Discard a prepared version and release the swap lock; the old
        version never stopped serving. Idempotent (False when nothing is
        staged)."""
        if self._staged is None:
            return False
        version = self._staged[0]
        self._staged = None
        self._swap_lock.release()
        record_failure("serving.swap_aborted", version=version,
                       tenant=self.tenant)
        return True

    def swap_from_store(self, store, builder: Callable,
                        step: Optional[int] = None,
                        warmup: bool = True) -> str:
        """Load a checkpoint (digest-verified by the store's manifest),
        build a handler from it via ``builder(checkpoint)``, and swap to it.
        ``step=None`` loads the newest VERIFIABLE checkpoint. A corrupt
        checkpoint, missing store, or builder failure raises
        :class:`SwapError` with the old version still serving."""
        # hold the swap lock across load+build as well (reentrant for the
        # delegated swap_to): two promoters racing swap_from_store must
        # resolve to one winner and one SwapError("swap in progress"), not
        # interleaved load/build/flip stages
        self._acquire_swap()
        try:
            return self._swap_from_store_locked(store, builder, step, warmup)
        finally:
            self._swap_lock.release()

    def _swap_from_store_locked(self, store, builder: Callable,
                                step: Optional[int],
                                warmup: bool) -> str:
        try:
            _swap_point("load", "?")
            ckpt = (store.load_step(step) if step is not None
                    else store.load_latest())
        except Exception as e:  # noqa: BLE001
            with self._lock:
                self.swap_failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
            record_failure("serving.swap_failed", stage="load",
                           error=type(e).__name__)
            raise SwapError(
                f"swap aborted: checkpoint load failed ({e}); "
                f"{self.active!r} is still serving") from e
        if ckpt is None:
            with self._lock:
                self.swap_failures += 1
                self.last_error = "no verifiable checkpoint"
            record_failure("serving.swap_failed", stage="load",
                           error="CheckpointError")
            raise SwapError(
                "swap aborted: the store holds no verifiable checkpoint; "
                f"{self.active!r} is still serving")
        version = ckpt.version
        with self._lock:
            if version == self.active:
                return version    # already serving these exact bytes
        try:
            handler = builder(ckpt)
        except Exception as e:  # noqa: BLE001
            with self._lock:
                self.swap_failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
            record_failure("serving.swap_failed", version=version,
                           stage="build", error=type(e).__name__)
            raise SwapError(
                f"swap to {version!r} aborted: builder failed ({e}); "
                f"{self.active!r} is still serving") from e
        return self.swap_to(version, handler, warmup=warmup)

    # -- rollback / retention --
    def rollback(self) -> str:
        """Flip back to the previously active version (still registered).
        Raises :class:`SwapError` when there is nothing to roll back to."""
        with self._lock:
            if len(self.history) < 2:
                raise SwapError("no previous version to roll back to")
            prev = self.history[-2]
            handler = self.versions[prev]
        return self.swap_to(prev, handler, warmup=False)

    def retire(self, version: str, wait_idle: bool = True,
               timeout: float = 10.0) -> bool:
        """Drop an inactive version. With ``wait_idle`` the call first waits
        for the server's pipeline stages to go idle (the drain machinery's
        accounting), so a pinned in-flight batch can never lose its handler.
        Returns False when the version is active or unknown."""
        with self._lock:
            if version == self.active or version not in self.versions:
                return False
        if wait_idle:
            self.server._idle.wait(timeout)
        with self._lock:
            if version == self.active:   # re-check: a swap may have raced
                return False
            self.versions.pop(version, None)
            if version in self.history:
                self.history.remove(version)
        return True

    def _prune(self) -> None:
        while True:
            with self._lock:
                if len(self.history) <= self.keep_versions:
                    return
                victim = self.history[0]
            if not self.retire(victim, wait_idle=True):
                return

    def snapshot(self) -> dict:
        with self._lock:
            return {"active": self.active,
                    "versions": list(self.history),
                    "swaps": self.swaps,
                    "swap_failures": self.swap_failures,
                    "last_error": self.last_error}
