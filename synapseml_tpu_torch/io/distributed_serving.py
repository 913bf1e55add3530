"""Distributed serving — a fault-tolerant multi-process fabric: per-process
workers, a load-balancing gateway with dynamic membership, bucket-aware
routing, and zero-downtime model hot-swap.

The port's counterpart of the JAX package's ``io/distributed_serving.py``,
host code throughout. Reference: DistributedHTTPSource
(core/.../streaming/DistributedHTTPSource.scala:203-312) runs a
``JVMSharedServer`` inside EVERY executor JVM and a ``WorkerServer`` per
partition (continuous/HTTPSourceV2.scala:485-713) with a request queue, a
reply-by-id routing table, and crashed-partition request rehydration; its
own cross-machine forwarding is left to an external load balancer. Here the
same worker-per-process architecture is kept (each process embeds a
:class:`~synapseml_tpu_torch.io.serving.ServingServer` running the SAME
handler — typically one replay of a captured CUDA graph per batch — on its
card), and the internal routing layer is implemented and dynamic:

* **Membership** — workers register and heartbeat with the gateway
  (``POST /__fabric/heartbeat``; :class:`WorkerAgent` is the worker-side
  reporter). Missed heartbeats EVICT a link — distinct from a breaker OPEN:
  eviction frees the link's routing state (connection pool, affinity,
  selection slot) while OPEN keeps the link and re-probes it. An evicted
  worker that heartbeats again rejoins cleanly, and brand-new workers can
  join a RUNNING gateway, which is the autoscaling hook
  :class:`FabricSupervisor` drives from queue-depth gauges.
* **Bucket-aware routing** — heartbeats advertise each worker's warmed
  bucket ladder (``BucketedRunner.warm_buckets()``); the gateway prefers
  the replica whose captured graphs already cover a request's batch bucket
  and keeps same-shape traffic sticky on one replica, falling back to
  least-loaded whenever the hint is absent or stale. Routing degrades,
  never fails: any shape-inference or staleness problem means "route by
  load".
* **Failover** — per-worker three-state circuit breakers, sibling retry on
  transport failure, deadline re-anchoring per hop, fast 502 only when no
  backend remains. The fabric invariant: an ACCEPTED request (non-503) is
  never dropped — it completes on some worker or fails its own deadline
  with a 504, even under worker kill, heartbeat partition, or
  kill-mid-swap.

Processes and cards: serving is host-side IO; each process drives one card
(several processes may share one), so "the process holding capacity" = the
worker whose in-flight count is lowest — unless a warm-ladder hint says a
sibling already holds the graph for the request's bucket. Micro-batching
happens inside ServingServer exactly as in the single-node mode, and model
hot-swap is the worker-local
:class:`~synapseml_tpu_torch.io.serving.ModelRegistry`. The worker-address
rendezvous of :class:`DistributedServingServer` is an all-gather over the
``torch.distributed`` world that ``parallel.initialize_distributed`` joins.
"""

from __future__ import annotations

import http.client
import json as _json
import queue
import random
import threading
import time
import uuid
from typing import (Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from ..core.gossip import ConsistentHashRing, GossipState
from ..core.logging import record_failure
from ..core.qos import (DEFAULT_TENANT, TENANT_HEADER, BudgetLeaseLedger,
                        QoSController)
from ..core.resilience import (DEADLINE_HEADER, CircuitBreaker, Deadline,
                               Membership)
from ..core.table import Table
from ..parallel.mesh import process_count, process_index
from .serving import ModelRegistry, ServingServer, _PendingRequest

#: Gateway control-plane path prefix — requests here are membership traffic,
#: never forwarded to a worker.
FABRIC_PATH_PREFIX = "/__fabric/"

#: Optional client hint: row count of a batched payload, for bucket-aware
#: routing without parsing the body.
SHAPE_ROWS_HEADER = "X-Batch-Rows"

# Heartbeat chaos hook: WorkerAgent consults it before every beat; a falsy
# return drops the beat on the floor (a network partition between worker and
# gateway that leaves the DATA path intact — the nastiest membership case).
# Installed by testing.chaos.chaos_heartbeat_partition; single global hook.
_HEARTBEAT_HOOK: Optional[Callable[[str], bool]] = None

# Control-plane chaos hook: the gateway replicator consults it before every
# gossip exchange with ``(source_gateway_id, peer_url)``; a falsy return
# drops the exchange — a partition of the REPLICATED control plane that
# leaves data paths and worker heartbeats intact. Installed by
# testing.chaos.chaos_control_plane_partition; single global hook.
_GOSSIP_HOOK: Optional[Callable[[str, str], bool]] = None


def _detect_local_ip() -> str:
    """Routable local address: the UDP-connect trick reads the kernel's
    chosen source interface without sending a packet —
    gethostbyname(gethostname()) resolves to 127.0.x.1 on common /etc/hosts
    configs, which would advertise an unreachable worker."""
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))   # no packets are sent
        return s.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())
    finally:
        s.close()


def _parse_hostport(url: str) -> Tuple[str, int]:
    """``http://h:p[/...]`` (or bare ``h:p``) -> (host, port)."""
    hostport = url.split("//", 1)[-1].split("/", 1)[0]
    h, _, p = hostport.partition(":")
    return h, int(p or 80)


class _GatewayStats:
    """Locked counters for the gateway (the ServingMetrics pattern from
    io/serving.py): handler threads increment concurrently, so every
    mutation and read takes the lock — the bare-dict += this replaces lost
    updates under contention. ``__getitem__`` keeps the historical
    ``gw.stats["forwarded"]`` read surface."""

    _COUNTERS = ("forwarded", "retried", "failed", "heartbeats", "joined",
                 "rejoined", "evicted", "deregistered",
                 "gossip_exchanges", "gossip_failed", "entries_merged",
                 "rate_limited")

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self._COUNTERS}

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._c[name]

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)


class _WorkerLink:
    """Connection pool + in-flight accounting + passive health for one
    downstream worker. Health is a three-state circuit breaker
    (core/resilience.py) fed only by the traffic that flows anyway: repeated
    transport failures OPEN the link (skipped by selection), an elapsed
    cooldown admits exactly one HALF-OPEN probe, and a probe success closes
    it again. Membership state (heartbeat-advertised warm buckets, queue
    depth, model version) rides on the link for routing reads."""

    def __init__(self, host: str, port: int, timeout: float,
                 breaker: Optional[CircuitBreaker] = None,
                 tenant_breaker_factory: Optional[Callable] = None):
        self.host, self.port = host, port
        self.timeout = timeout
        self.inflight = 0
        self.breaker = breaker or CircuitBreaker()
        self.ok_count = 0
        self.fail_count = 0
        # membership-advertised routing state (updated by heartbeats; all
        # advisory — routing must work with every field at its default)
        self.worker_id: Optional[str] = None
        self.warm_buckets: Tuple[int, ...] = ()
        self.queue_depth: int = 0
        self.version: Optional[str] = None
        # per-(tenant, model) advertisement: tenant -> {"version",
        # "warm_buckets"} — the multi-tenant warm-ladder/version routing
        # inputs (advisory, like everything heartbeat-carried)
        self.tenants: Dict[str, dict] = {}
        # per-tenant passive health: the LINK breaker is transport-level
        # (this worker is unreachable for everyone); a TENANT breaker is
        # "this worker is 5xxing tenant T" (bad model version, poisoned
        # state) — T's traffic skips the replica while other tenants keep
        # using it
        self._tenant_breaker_factory = tenant_breaker_factory or \
            CircuitBreaker
        self.tenant_breakers: Dict[str, CircuitBreaker] = {}
        self._pool: "queue.LifoQueue[http.client.HTTPConnection]" = \
            queue.LifoQueue()
        self._lock = threading.Lock()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # back-compat views of the breaker state (older health consumers)
    @property
    def failures(self) -> int:
        return self.breaker.consecutive_failures

    @property
    def down_until(self) -> float:
        return self.breaker.open_until if \
            self.breaker.state == CircuitBreaker.OPEN else 0.0

    def update_membership(self, info: Dict) -> None:
        with self._lock:
            if "id" in info and info["id"]:
                self.worker_id = str(info["id"])
            if "warm_buckets" in info:
                try:
                    self.warm_buckets = tuple(
                        sorted(int(b) for b in info["warm_buckets"]))
                except (TypeError, ValueError):
                    pass    # advisory data: garbage degrades, never breaks
            if "queue_depth" in info:
                try:
                    self.queue_depth = int(info["queue_depth"])
                except (TypeError, ValueError):
                    pass
            if "version" in info and info["version"] is not None:
                self.version = str(info["version"])
            if isinstance(info.get("tenants"), dict):
                tenants = {}
                for t, entry in info["tenants"].items():
                    if not isinstance(entry, dict):
                        continue    # advisory: garbage degrades
                    parsed = {}
                    if entry.get("version") is not None:
                        parsed["version"] = str(entry["version"])
                    try:
                        parsed["warm_buckets"] = tuple(sorted(
                            int(b) for b in entry.get("warm_buckets", ())))
                    except (TypeError, ValueError):
                        parsed["warm_buckets"] = ()
                    tenants[str(t)] = parsed
                self.tenants = tenants

    def covers_bucket(self, rows: int,
                      tenant: Optional[str] = None) -> bool:
        """Does this worker's advertised warm ladder already hold a compiled
        bucket for a ``rows``-row micro-batch? With a tenant, THAT tenant's
        advertised ladder is consulted (falling back to the worker-wide one
        when the tenant never advertised). False when nothing was ever
        advertised — staleness degrades to load-based routing."""
        with self._lock:
            ladder = self.warm_buckets
            if tenant is not None:
                entry = self.tenants.get(tenant)
                if entry is not None and entry.get("warm_buckets"):
                    ladder = entry["warm_buckets"]
            return any(rows <= b for b in ladder)

    def tenant_available(self, tenant: Optional[str], now: float) -> bool:
        """Non-mutating per-tenant health read (selection-loop safe); a
        tenant with no breaker yet is healthy by definition."""
        if tenant is None:
            return True
        with self._lock:
            breaker = self.tenant_breakers.get(tenant)
        return breaker is None or breaker.available(now)

    def mark_tenant(self, tenant: Optional[str], ok: bool) -> None:
        """Feed a forwarded reply's verdict to the tenant's breaker: 5xx
        replies for tenant T on this replica eventually OPEN (T's traffic
        skips it) without touching the transport breaker or other
        tenants."""
        if tenant is None:
            return
        with self._lock:
            breaker = self.tenant_breakers.get(tenant)
            if breaker is None:
                if ok:
                    return          # no state to close; don't allocate
                breaker = self.tenant_breakers[tenant] = \
                    self._tenant_breaker_factory()
        if ok:
            breaker.record_success()
        else:
            breaker.record_failure()
            record_failure("gateway.tenant_backend_failure",
                           worker=self.url, tenant=tenant)

    def close(self) -> None:
        """Free routing state on eviction: every pooled keep-alive
        connection is closed (an evicted worker's sockets must not linger
        until GC)."""
        while True:
            try:
                self._pool.get_nowait().close()
            except queue.Empty:
                return
            except OSError:
                pass

    def _get_conn(self) -> Optional[http.client.HTTPConnection]:
        """Pooled connection or None (callers then dial fresh)."""
        try:
            return self._pool.get_nowait()
        except queue.Empty:
            return None

    def forward(self, method: str, path: str, body: bytes,
                headers: Dict[str, str]) -> tuple:
        """One forwarded request; returns (status, body). Raises on transport
        failure (caller retries on a sibling). A failure on a POOLED
        keep-alive connection retries once on a FRESH one first: workers
        close idle connections after ~30s (serving.py Handler.timeout), and
        that stale-socket error must not read as a dead worker — it would
        cool down every healthy worker after any idle period."""
        def send(conn):
            try:
                conn.request(method, path, body=body, headers=headers)
                r = conn.getresponse()
                payload = r.read()
                self._pool.put(conn)
                return r.status, payload
            except Exception:
                conn.close()       # broken conn must not re-pool
                raise

        pooled = self._get_conn()
        if pooled is not None:
            try:
                return send(pooled)
            except Exception:
                pass               # stale keep-alive conn: retry fresh below
        return send(http.client.HTTPConnection(self.host, self.port,
                                               timeout=self.timeout))

    def mark_ok(self) -> None:
        with self._lock:
            self.ok_count += 1
        self.breaker.record_success()

    def mark_failed(self) -> None:
        with self._lock:
            self.fail_count += 1
        self.breaker.record_failure()
        record_failure("gateway.backend_failure", worker=self.url)

    def health(self, now: float) -> Dict:
        with self._lock:
            member = {"worker_id": self.worker_id,
                      "warm_buckets": list(self.warm_buckets),
                      "queue_depth": self.queue_depth,
                      "version": self.version,
                      "tenants": {
                          t: {**{k: (list(v) if isinstance(v, tuple)
                                     else v) for k, v in e.items()},
                              **({"breaker": self.tenant_breakers[t]
                                  .snapshot()}
                                 if t in self.tenant_breakers else {})}
                          for t, e in self.tenants.items()}}
        return {"url": self.url, "inflight": self.inflight,
                "ok": self.ok_count, "failed": self.fail_count,
                "down": not self.breaker.available(now),
                **member, **self.breaker.snapshot()}


class ServingGateway:
    """Public endpoint forwarding to per-process workers (the implemented
    version of the reference's stubbed InternalHandler shuffle routing),
    with dynamic membership.

    ``mode``: ``least_loaded`` (default — route to the worker with the
    fewest in-flight forwards, upgraded to bucket-aware when heartbeats
    advertise warm ladders) or ``round_robin``. A worker that fails a
    forward trips its circuit breaker toward OPEN (``breaker_threshold``
    consecutive transport failures; ``cooldown`` seconds out, escalating on
    repeated trips) and the request retries on a sibling; an OPEN worker is
    skipped entirely until its cooldown admits a half-open probe. Only when
    every worker fails — or every breaker is open — does the client see a
    fast 502 (single-request semantics preserved: at-most-once per worker,
    the reply returns to the original caller's still-open connection —
    reply-by-id across processes). A client ``X-Deadline-Ms`` budget is
    re-anchored here and propagated to the worker, and sibling retries stop
    once it expires.

    Membership: links created from ``worker_urls`` are STATIC members —
    they never expire, preserving the fixed-list deployment mode. The
    moment a worker heartbeats (``POST /__fabric/heartbeat``) it becomes a
    dynamic member: ``heartbeat_timeout`` seconds of silence EVICTS it
    (link removed, pooled connections closed, affinity forgotten —
    ``gateway.worker_evicted``), and a later heartbeat from the same url
    rejoins it with a fresh breaker. New workers may heartbeat-join a
    running gateway at any time. Breaker OPEN and eviction are deliberately
    different states: OPEN is "failing traffic right now, keep probing";
    evicted is "gone — free everything, welcome it back if it returns".
    """

    def __init__(self, worker_urls: Sequence[str], host: str = "127.0.0.1",
                 port: int = 0, api_path: str = "/",
                 mode: str = "least_loaded", forward_timeout: float = 30.0,
                 cooldown: float = 1.0, breaker_threshold: int = 3,
                 max_retries: Optional[int] = None,
                 local_worker: Optional[ServingServer] = None,
                 local_index: Optional[int] = None,
                 heartbeat_timeout: float = 3.0,
                 clock=time.monotonic,
                 gateway_id: Optional[str] = None,
                 peers: Sequence[str] = (),
                 gossip_interval: float = 0.25,
                 gossip_timeout: float = 2.0,
                 peer_timeout: Optional[float] = None,
                 lease_ttl: float = 2.0,
                 qos: Optional[QoSController] = None):
        if mode not in ("least_loaded", "round_robin"):
            raise ValueError(f"unknown load-balancing mode {mode!r}")
        self.breaker_threshold = breaker_threshold
        self.forward_timeout = forward_timeout
        self.cooldown = cooldown
        self._clock = clock
        self.membership = Membership(timeout=heartbeat_timeout, clock=clock)
        self.links: List[_WorkerLink] = []
        for u in worker_urls:
            link = self._make_link(u)
            self.links.append(link)
            # static member: a configured URL with no heartbeat reporter
            # stays routable forever (liveness is the breaker's job alone)
            self.membership.beat(link.url, static=True)
        # the co-located worker (same process as the gateway): requests
        # routed to it enqueue DIRECTLY into its micro-batch queue instead
        # of paying a loopback HTTP round trip — the reference gets the same
        # effect from its shared-JVM SharedSingleton server. Identified by
        # INDEX in worker_urls (ports collide across hosts); port matching
        # is the single-host fallback.
        self._local = local_worker
        self._local_link = None
        if local_worker is not None:
            if local_index is not None:
                if not 0 <= local_index < len(self.links):
                    raise ValueError(
                        f"local_index {local_index} out of range for "
                        f"{len(self.links)} workers")
                self._local_link = self.links[local_index]
            else:
                # single-host fallback: host AND port must match — ports
                # alone collide across hosts (the normal StatefulSet
                # topology), and mis-marking a remote link as local would
                # silently starve that worker. A worker bound to the
                # wildcard address matches only link hosts that resolve to
                # THIS machine (loopback or the detected interface address).
                self_hosts = {"127.0.0.1", "localhost", local_worker.host}
                if local_worker.host in ("0.0.0.0", "::", ""):
                    self_hosts.add(_detect_local_ip())
                for l in self.links:
                    if l.port == local_worker.port and l.host in self_hosts:
                        self._local_link = l
                        break
        if not self.links:
            raise ValueError("gateway needs at least one worker url")
        self.host, self.port = host, port
        self.api_path = api_path
        self.mode = mode
        # None = dynamic: retry across however many workers exist NOW (the
        # membership can grow/shrink after start)
        self._max_retries_cfg = max_retries
        self._rr = 0
        self._lock = threading.Lock()
        self._httpd = None
        self.stats = _GatewayStats()
        # shape-affinity routing table: shape key -> worker url. Sticky
        # same-shape traffic concentrates each shape's bucket ladder onto
        # one replica's captured graphs. Bounded FIFO; purely advisory.
        self._affinity: Dict = {}
        self._affinity_cap = 256
        # --- federation: replicated control plane over /__fabric/gossip ---
        # Every gateway holds a GossipState whether or not it has peers; the
        # replicator thread only runs once a peer is configured, so the
        # single-gateway deployment pays nothing.
        self.gateway_id = gateway_id or uuid.uuid4().hex[:12]
        self.gossip = GossipState(self.gateway_id, clock=clock)
        self.gossip_interval = gossip_interval
        self.gossip_timeout = gossip_timeout
        # a peer gateway whose liveness entry stops advancing for this long
        # is dead: its ring arcs rehash and its leases expire
        self.peer_timeout = peer_timeout if peer_timeout is not None \
            else max(4.0 * gossip_interval, 1.0)
        self.lease_ttl = lease_ttl
        # edge-tier QoS: when set, THIS gateway admits per-tenant with its
        # leased share of the class's GLOBAL rate (core/qos.py lease math)
        self.qos = qos
        self.leases = BudgetLeaseLedger(ttl=lease_ttl, clock=clock)
        self.ring = ConsistentHashRing()
        self._active_tenants: Dict[str, float] = {}
        self._peer_urls: List[str] = []
        self._peer_state: Dict[str, dict] = {}   # url -> exchange health
        self._peer_rr = 0
        self.public_url: Optional[str] = None    # resolved in start()
        self._killed = threading.Event()
        self._repl_stop = threading.Event()
        self._repl_thread: Optional[threading.Thread] = None
        for p in peers:
            self.add_peer(p)

    # --- membership -----------------------------------------------------
    def _make_link(self, url: str) -> _WorkerLink:
        h, p = _parse_hostport(url)
        mk = lambda: CircuitBreaker(  # noqa: E731
            failure_threshold=self.breaker_threshold, cooldown=self.cooldown)
        return _WorkerLink(h, p, self.forward_timeout, breaker=mk(),
                           tenant_breaker_factory=mk)

    def register_worker(self, url: str, _replicate: bool = True,
                        **info) -> _WorkerLink:
        """Programmatic join: add (or refresh) a worker link on a RUNNING
        gateway. Idempotent by url; an evicted worker re-registering gets a
        fresh link and breaker (clean rejoin). This is also what a
        ``/__fabric/heartbeat`` from an unknown url does. On a federated
        gateway the (re)registration replicates as a ``member/<url>``
        gossip entry so every peer gateway can route to the worker;
        ``_replicate=False`` is the merge path applying a PEER's entry
        (replicated state must not re-publish — the origin's epoch already
        carries it)."""
        h, p = _parse_hostport(url)
        canonical = f"http://{h}:{p}"
        with self._lock:
            link = next((l for l in self.links if l.url == canonical), None)
            created = link is None
            if created:
                link = self._make_link(canonical)
                self.links.append(link)
        fields = {k: v for k, v in info.items() if k in (
            "queue_depth", "warm_buckets", "version", "id", "tenants")}
        admitted = self.membership.beat(canonical, **fields)
        link.update_membership(info)
        if created:
            self.stats.incr("rejoined" if admitted == "rejoin"
                            else "joined")
            record_failure("gateway.worker_joined", worker=canonical)
        if _replicate and self.federated:
            self.gossip.publish(
                f"member/{canonical}",
                {k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in fields.items()})
        return link

    def deregister_worker(self, url: str) -> bool:
        """Voluntary leave (clean scale-down): evict immediately without
        waiting for the heartbeat timeout."""
        h, p = _parse_hostport(url)
        return self._evict(f"http://{h}:{p}", reason="deregistered")

    def _evict(self, url: str, reason: str = "evicted",
               only_if_expired: bool = False,
               _replicate: bool = True) -> bool:
        """Remove a worker from routing entirely and free its state. The
        counterpart of breaker OPEN: OPEN keeps the link and re-probes;
        eviction forgets it (until a rejoin). ``only_if_expired`` is the
        lazy-sweep mode: staleness is re-checked under the membership lock
        (:meth:`Membership.evict_if_expired`), so a worker whose rejoin
        beat raced the sweep keeps its link and affinity. On a federated
        gateway the eviction replicates as a tombstone — peers must not
        resurrect a dead worker at the next exchange."""
        if only_if_expired:
            if not self.membership.evict_if_expired(url):
                return False
        else:
            self.membership.evict(url)
        with self._lock:
            link = next((l for l in self.links if l.url == url), None)
            if link is None:
                return False
            self.links.remove(link)
            if link is self._local_link:
                self._local_link = None
            # forget this worker's shape affinities so sticky routing
            # re-pins surviving replicas on the next request
            self._affinity = {k: v for k, v in self._affinity.items()
                              if v != url}
        link.close()
        self.stats.incr("deregistered" if reason == "deregistered"
                        else "evicted")
        record_failure(f"gateway.worker_{reason}", worker=url)
        if _replicate and self.federated:
            self.gossip.retract(f"member/{url}")
        return True

    def _sweep_expired(self) -> None:
        """Evict every member whose heartbeat is overdue. Called lazily
        from the selection path and the health endpoint — no sweeper
        thread to leak. Per-member staleness is re-checked under the lock,
        closing the rejoin-during-lazy-eviction race."""
        for url in self.membership.expired():
            self._evict(url, reason="evicted", only_if_expired=True)

    def evict_stale(self) -> list:
        """Explicit idle sweep: the lazy :meth:`_sweep_expired` only runs
        on the routing/health path, so a gateway receiving ZERO traffic
        holds dead workers indefinitely. Supervisor loops
        (:meth:`FabricSupervisor.step`) call this on their own cadence;
        evictions are counted under ``fabric.evicted_idle``."""
        stale = self.membership.expired()
        evicted = [url for url in stale
                   if self._evict(url, reason="evicted",
                                  only_if_expired=True)]
        if evicted:
            record_failure("fabric.evicted_idle", n=len(evicted),
                           members=[str(u) for u in evicted])
        return evicted

    def _handle_control(self, path: str, body: bytes) -> Tuple[int, dict]:
        """Membership control-plane dispatch for ``/__fabric/*`` POSTs."""
        try:
            payload = _json.loads(body.decode()) if body else {}
        except ValueError:
            return 400, {"error": "control payload must be JSON"}
        if not isinstance(payload, dict):
            return 400, {"error": "control payload must be a JSON object"}
        op = path[len(FABRIC_PATH_PREFIX):].strip("/")
        if op == "gossip":
            # anti-entropy push-pull: merge the peer's entries, reply with
            # full local state (their merge of our reply completes the
            # round — one exchange converges both sides)
            self._absorb(str(payload.get("from", "")),
                         payload.get("clock", 0),
                         payload.get("entries", ()))
            return 200, {"ok": True, "from": self.gateway_id,
                         "clock": self.gossip.lamport,
                         "entries": self.gossip.wire()}
        if not payload.get("url"):
            return 400, {"error": "control payload needs a worker 'url'"}
        if op in ("heartbeat", "register"):
            before = set(self.membership.members())
            info = {k: v for k, v in payload.items() if k != "url"}
            link = self.register_worker(str(payload["url"]), **info)
            self.stats.incr("heartbeats")
            self._sweep_expired()
            with self._lock:
                n_workers = len(self.links)
            return 200, {"ok": True, "worker": link.url,
                         "known": link.url in before,
                         "workers": n_workers,
                         # live gateway peers, so WorkerAgent learns every
                         # gateway it can fail its beats over to
                         "gateway_id": self.gateway_id,
                         "peers": self.gateway_urls()}
        if op == "deregister":
            gone = self.deregister_worker(str(payload["url"]))
            with self._lock:
                n_workers = len(self.links)
            return 200, {"ok": True, "removed": gone,
                         "workers": n_workers}
        return 404, {"error": f"unknown fabric op {op!r}"}

    # --- federation: replicated control plane ---------------------------
    @property
    def federated(self) -> bool:
        with self._lock:
            return bool(self._peer_urls)

    def alive(self) -> bool:
        """False once chaos hard-killed this gateway (kill_gateway) — the
        coordinator-liveness input to a survivable PromotionBroadcast."""
        return not self._killed.is_set()

    def add_peer(self, url: str) -> None:
        """Teach this gateway a peer gateway's address (idempotent). The
        replicator thread starts with the first peer on a RUNNING gateway;
        peers added before :meth:`start` begin exchanging at start."""
        h, p = _parse_hostport(url)
        base = f"http://{h}:{p}"
        with self._lock:
            if base not in self._peer_urls:
                self._peer_urls.append(base)
                self._peer_state[base] = {"last_ok": None, "failures": 0,
                                          "clock": 0}
        if self._httpd is not None:
            self._start_replicator()

    def gateway_urls(self) -> List[str]:
        """Public urls of every gateway believed alive (self included) —
        what heartbeat acks advertise so workers can fail over."""
        urls = [self.public_url] if self.public_url else []
        now = self._clock()
        for info in self._peers_alive(now).values():
            if info["alive"] and info["url"] and info["url"] not in urls:
                urls.append(info["url"])
        return urls

    def tenant_home(self, tenant: str) -> Optional[str]:
        """Consistent-hash tenant→gateway affinity: the public url of the
        gateway that should front ``tenant``. Every converged gateway
        computes the same answer; a gateway death rehashes ONLY the dead
        gateway's tenants (ring minimal movement), so warm-ladder routing
        keeps seeing stable (tenant, shape) streams on the survivors."""
        return self.ring.node_for(tenant) or self.public_url

    def _absorb(self, src_id: str, clock, entries) -> List:
        """Merge a peer's entries + clock (request or reply side) and
        apply every accepted entry to local routing/QoS state."""
        if src_id and src_id != self.gateway_id:
            try:
                self.gossip.observe_peer_clock(src_id, int(clock))
            except (TypeError, ValueError):
                pass
        accepted = self.gossip.merge(entries)
        if accepted:
            self.stats.incr("entries_merged", len(accepted))
            self._apply_entries(accepted)
        return accepted

    def _apply_entries(self, accepted) -> None:
        """Fold accepted gossip entries into live gateway state: member
        entries register/evict worker links (so ANY gateway routes to ANY
        worker from converged state), lease entries feed the budget
        ledger, gateway entries refresh the affinity ring. ``promo/``
        records are read lazily by broadcast recovery, not here."""
        ring_dirty = False
        for e in accepted:
            if e.key.startswith("member/"):
                url = e.key[len("member/"):]
                if e.value is None:
                    self._evict(url, reason="evicted", _replicate=False)
                else:
                    self.register_worker(url, _replicate=False, **e.value)
            elif e.key.startswith("lease/"):
                parts = e.key.split("/", 2)
                if len(parts) != 3:
                    continue
                _, tenant, holder = parts
                if e.value is None:
                    self.leases.release(tenant, holder)
                else:
                    self.leases.observe(tenant, holder)
                if self.qos is not None:
                    self.qos.set_rate_share(
                        tenant, self.leases.share(tenant, self.gateway_id))
            elif e.key.startswith("gateway/"):
                ring_dirty = True
        if ring_dirty:
            self._refresh_ring(self._clock())

    # --- federation: edge QoS with leased sub-budgets -------------------
    def edge_admit(self, tenant: str):
        """Edge-tier admission: this gateway's token bucket refills at its
        LEASED share of the tenant's global rate (1/n live leaseholders),
        so K gateways admitting independently enforce one fabric-wide
        per-tenant contract. First contact claims the lease immediately;
        the replicator renews it every tick and retracts it after
        ``lease_ttl`` of tenant silence."""
        self._touch_tenant(tenant)
        decision = self.qos.admit(tenant)
        if not decision.ok:
            self.stats.incr("rate_limited")
        return decision

    def _touch_tenant(self, tenant: str) -> None:
        now = self._clock()
        with self._lock:
            new = tenant not in self._active_tenants
            self._active_tenants[tenant] = now
        if new and self.federated:
            self._renew_lease(tenant)

    def _renew_lease(self, tenant: str) -> None:
        self.gossip.publish(f"lease/{tenant}/{self.gateway_id}",
                            {"holder": self.gateway_id})
        self.leases.observe(tenant, self.gateway_id)
        if self.qos is not None:
            self.qos.set_rate_share(
                tenant, self.leases.share(tenant, self.gateway_id))

    def _renew_leases(self, now: float) -> None:
        with self._lock:
            active = dict(self._active_tenants)
        for tenant, last in active.items():
            if now - last > self.lease_ttl:
                # tenant went quiet here: release our slice so surviving
                # enforcers' shares grow back toward the full contract
                with self._lock:
                    self._active_tenants.pop(tenant, None)
                self.gossip.retract(f"lease/{tenant}/{self.gateway_id}")
                self.leases.release(tenant, self.gateway_id)
            else:
                self._renew_lease(tenant)
        if self.qos is not None:
            for tenant in set(self.leases.tenants()) | set(active):
                self.qos.set_rate_share(
                    tenant, self.leases.share(tenant, self.gateway_id))

    # --- federation: replicator loop ------------------------------------
    def _peers_alive(self, now: float) -> Dict[str, dict]:
        """Peer gateways by id, judged on how recently their liveness
        entry advanced LOCALLY (no cross-host clocks): a peer whose entry
        went ``peer_timeout`` without advancing is dead — partitioned or
        killed — and its arcs leave the affinity ring."""
        out: Dict[str, dict] = {}
        for key, info in self.gossip.items("gateway/").items():
            gid = key[len("gateway/"):]
            if gid == self.gateway_id:
                continue
            at = self.gossip.advanced_at(key)
            age = (now - at) if at is not None else float("inf")
            out[gid] = {"url": info.get("url"),
                        "last_advance_age_s": round(age, 3),
                        "alive": age <= self.peer_timeout}
        return out

    def _refresh_ring(self, now: float) -> None:
        want = {self.public_url} if self.public_url else set()
        for info in self._peers_alive(now).values():
            if info["alive"] and info["url"]:
                want.add(info["url"])
        for node in self.ring.nodes():
            if node not in want:
                self.ring.remove(node)
                record_failure("gateway.peer_left_ring", peer=node)
        for node in want:
            self.ring.add(node)

    def _exchange_once(self) -> bool:
        """One push-pull anti-entropy exchange with the next peer in
        round-robin order. Chaos (``_GOSSIP_HOOK``) or transport failure
        drops the exchange — never the gateway."""
        with self._lock:
            if not self._peer_urls:
                return False
            self._peer_rr += 1
            peer = self._peer_urls[self._peer_rr % len(self._peer_urls)]
        hook = _GOSSIP_HOOK
        if hook is not None and not hook(self.gateway_id, peer):
            self.stats.incr("gossip_failed")
            return False
        body = _json.dumps({"from": self.gateway_id,
                            "clock": self.gossip.lamport,
                            "entries": self.gossip.wire()}).encode()
        h, p = _parse_hostport(peer)
        try:
            conn = http.client.HTTPConnection(h, p,
                                              timeout=self.gossip_timeout)
            try:
                conn.request("POST", FABRIC_PATH_PREFIX + "gossip",
                             body=body,
                             headers={"Content-Type": "application/json"})
                reply = _json.loads(conn.getresponse().read().decode())
            finally:
                conn.close()
        except Exception:  # noqa: BLE001 — a dead peer is routine here
            with self._lock:
                state = self._peer_state.get(peer)
                if state is not None:
                    state["failures"] += 1
            self.stats.incr("gossip_failed")
            record_failure("gateway.gossip_exchange_failed", peer=peer)
            return False
        self._absorb(str(reply.get("from", "")), reply.get("clock", 0),
                     reply.get("entries", ()))
        with self._lock:
            state = self._peer_state.get(peer)
            if state is not None:
                state["last_ok"] = self._clock()
                try:
                    state["clock"] = int(reply.get("clock", 0))
                except (TypeError, ValueError):
                    pass
        self.stats.incr("gossip_exchanges")
        return True

    def _replicate_once(self) -> None:
        now = self._clock()
        # our own liveness entry: the advancing epoch IS the heartbeat
        self.gossip.publish(f"gateway/{self.gateway_id}",
                            {"url": self.public_url})
        self._renew_leases(now)
        self._refresh_ring(now)
        self._exchange_once()

    def _replicate_loop(self) -> None:
        while not self._repl_stop.is_set() and not self._killed.is_set():
            try:
                self._replicate_once()
            except Exception:  # noqa: BLE001 — replication must not die
                record_failure("gateway.gossip_error")
            self._repl_stop.wait(self.gossip_interval)

    def _start_replicator(self) -> None:
        with self._lock:
            if self._repl_thread is not None:
                return
            self._repl_thread = threading.Thread(
                target=self._replicate_loop, daemon=True,
                name=f"gossip-{self.gateway_id}")
        self._replicate_once()      # eager first advertisement + exchange
        self._repl_thread.start()

    def federation_snapshot(self) -> dict:
        """Control-plane observability: replication lag (entries behind
        the newest epoch known anywhere), peer liveness, ring membership,
        lease state — the numbers that show a partition before it bites."""
        now = self._clock()
        with self._lock:
            peer_state = {u: dict(s) for u, s in self._peer_state.items()}
        for s in peer_state.values():
            last = s.pop("last_ok", None)
            s["last_exchange_age_s"] = (round(now - last, 3)
                                        if last is not None else None)
        return {"gateway_id": self.gateway_id,
                "public_url": self.public_url,
                "clock": self.gossip.lamport,
                "entries_behind": self.gossip.entries_behind(),
                "peers": self._peers_alive(now),
                "exchanges": peer_state,
                "ring": self.ring.nodes(),
                "leases": self.leases.snapshot(),
                "gossip": self.gossip.snapshot()}

    # --- worker selection ----------------------------------------------
    def _shape_hint(self, body: bytes,
                    headers=None) -> Optional[Tuple[int, Optional[tuple]]]:
        """(rows, shape_key) inferred from a request, or None. The hint is
        ADVISORY and this helper must degrade, never fail: any parse
        problem, oversized body, or unfamiliar payload shape returns None
        and routing falls back to least-loaded. An explicit
        ``X-Batch-Rows`` header skips body parsing entirely."""
        try:
            if headers is not None:
                raw = headers.get(SHAPE_ROWS_HEADER)
                if raw:
                    return max(int(raw), 1), None
            if not body or len(body) > 4096 or body[:1] != b"{":
                return None
            obj = _json.loads(body)
            if not isinstance(obj, dict):
                return None
            for k in sorted(obj):
                v = obj[k]
                if isinstance(v, list) and v:
                    if isinstance(v[0], list):
                        # batched payload: rows x features
                        return len(v), (k, len(v[0]))
                    return 1, (k, len(v))
            return None
        except Exception:  # noqa: BLE001 — a hint must never fail a request
            return None

    def _pick(self, exclude: set,
              hint: Optional[Tuple[int, Optional[tuple]]] = None,
              tenant: Optional[str] = None) -> Optional[_WorkerLink]:
        now = self._clock()
        self._sweep_expired()
        # the gateway lock guards only the membership LIST; breaker/tenant
        # probes take each link's own lock, so they run on a snapshot —
        # the router never nests the gateway lock around a link lock
        with self._lock:
            candidates = list(self.links)
        up = [l for l in candidates
              if id(l) not in exclude and l.breaker.available(now)
              and l.tenant_available(tenant, now)]
        if not up:
            # every remaining worker's breaker is OPEN inside its
            # cooldown (transport-wide, or for THIS tenant): fail fast
            # (the breaker's whole point) instead of dialing known-bad
            # backends
            return None
        if self.mode == "round_robin":
            with self._lock:
                self._rr += 1
                rr = self._rr
            order = up[rr % len(up):] + up[:rr % len(up)]
        else:
            order = self._bucket_aware_order(up, hint, tenant)
        # try_acquire consumes the single half-open probe slot; a link
        # that loses the probe race falls through to the next candidate
        for link in order:
            if link.breaker.try_acquire(now):
                if hint is not None and hint[1] is not None:
                    with self._lock:
                        self._pin_affinity((tenant, hint[1]), link.url)
                return link
        return None

    def _bucket_aware_order(self, up: List[_WorkerLink], hint,
                            tenant: Optional[str] = None
                            ) -> List[_WorkerLink]:
        """Least-loaded order, upgraded by routing hints when present:
        (1) replicas whose advertised warm ladder already covers the
        request's bucket sort first (a captured graph beats an idle replica
        that would pay a capture) — per-TENANT ladders when the
        workers advertise them, (2) the (tenant, shape) sticky affinity
        replica wins ties (each tenant's same-shape traffic concentrates
        one cache), and (3) in-flight load breaks the rest. With no hint —
        or stale/absent bucket info — this IS plain least-loaded. Takes
        _lock only for the affinity read; the covers_bucket probes call
        into each link's own lock and must not nest under it."""
        if hint is None:
            return sorted(up, key=lambda l: l.inflight)
        rows, key = hint
        with self._lock:
            sticky = (self._affinity.get((tenant, key))
                      if key is not None else None)
        return sorted(up, key=lambda l: (
            0 if l.covers_bucket(rows, tenant) else 1,
            0 if sticky is not None and l.url == sticky else 1,
            l.inflight))

    def _tenant_blocked(self, tenant: Optional[str]) -> bool:
        """Is the fabric up but THIS tenant quarantined on every reachable
        replica? That is a per-tenant 503 (the tenant's own isolation
        boundary), not a 502 (fabric down)."""
        if tenant is None:
            return False
        now = self._clock()
        with self._lock:
            candidates = list(self.links)
        up = [l for l in candidates if l.breaker.available(now)]
        return bool(up) and not any(
            l.tenant_available(tenant, now) for l in up)

    def _pin_affinity(self, key, url: str) -> None:
        # caller holds _lock
        if key not in self._affinity and \
                len(self._affinity) >= self._affinity_cap:
            self._affinity.pop(next(iter(self._affinity)))
        self._affinity[key] = url

    def _forward(self, method: str, path: str, body: bytes,
                 headers: Dict[str, str],
                 deadline: Optional[Deadline] = None,
                 hint: Optional[tuple] = None,
                 tenant: Optional[str] = None) -> tuple:
        tried: set = set()
        last_err = None
        last_shed: Optional[tuple] = None
        # dynamic retry bound: one attempt per CURRENT member by default
        # (membership can grow/shrink while the gateway runs)
        with self._lock:
            retries = (self._max_retries_cfg
                       if self._max_retries_cfg is not None
                       else max(len(self.links), 1))
        for _ in range(retries):
            if deadline is not None and deadline.expired():
                record_failure("gateway.deadline_expired")
                return 504, b'{"error": "deadline exceeded at gateway"}'
            link = self._pick(tried, hint, tenant)
            if link is None:
                break
            tried.add(id(link))
            with self._lock:
                link.inflight += 1
                is_local = link is self._local_link
            try:
                if deadline is not None:
                    # re-anchor the remaining budget for the next hop
                    headers = {**headers,
                               DEADLINE_HEADER: deadline.header_value()}
                if is_local:
                    status, payload = self._forward_local(body, deadline,
                                                          tenant)
                else:
                    status, payload = link.forward(method, path, body,
                                                   headers)
                link.mark_ok()
                # per-tenant passive health: 5xx replies (handler throw,
                # NaN guard, bad version) count against THIS replica for
                # THIS tenant; anything below 500 — including the
                # tenant's own 429s — is a healthy replica for it
                link.mark_tenant(tenant, ok=status < 500)
                if status == 503:
                    # shed failover: a 503 is the worker's backpressure
                    # (admission queue full or draining), not a broken
                    # link — no breaker penalty, but a sibling may have
                    # capacity, so the request fails over instead of
                    # surfacing one replica's shed to the client. Only
                    # when EVERY candidate sheds does the 503 go out.
                    last_shed = (status, payload)
                    self.stats.incr("retried")
                    record_failure("gateway.shed_failover", worker=link.url)
                    continue
                self.stats.incr("forwarded")
                return status, payload
            except Exception as e:  # transport failure -> retry on sibling
                last_err = e
                link.mark_failed()
                self.stats.incr("retried")
                record_failure("gateway.retry", worker=link.url)
            finally:
                with self._lock:
                    link.inflight -= 1
        if last_shed is not None:
            # every reachable worker shed: the honest answer is the 503
            # (client backoff), not a 502 pretending the fabric is down
            self.stats.incr("forwarded")
            return last_shed
        if self._tenant_blocked(tenant):
            # the fabric is up — it is THIS tenant that is open-circuited
            # on every replica (bad version, NaN storm): a per-tenant 503
            # at the gateway boundary, never a 502 that would read as a
            # fabric outage to every other tenant's operators
            self.stats.incr("forwarded")
            record_failure("gateway.tenant_quarantined", tenant=tenant)
            return 503, _json.dumps(
                {"error": "tenant quarantined", "tenant": tenant}).encode()
        self.stats.incr("failed")
        record_failure("gateway.no_backend")
        return 502, (b'{"error": "no serving worker reachable: %s"}'
                     % str(last_err).encode()[:200])

    def _forward_local(self, body: bytes,
                       deadline: Optional[Deadline] = None,
                       tenant: Optional[str] = None) -> tuple:
        """In-process fast path: enqueue into the co-located worker's
        micro-batch queue and wait for its reply-by-id, skipping the
        loopback HTTP hop entirely."""
        if self._local._stop.is_set() or self._local._draining.is_set():
            # fail as fast as the HTTP path's ECONNREFUSED / 503 would: the
            # queue accepts puts forever, but a stopped serve loop never
            # replies and a draining one should shed
            raise ConnectionError("local serving worker is stopped/draining")
        if tenant is not None and self._local.qos is not None:
            # the fast path honors the worker's per-tenant QoS boundary
            # exactly like its HTTP admission would
            decision = self._local.qos.admit(tenant)
            if not decision.ok:
                return decision.status, _json.dumps(
                    {"error": decision.reason, "tenant": tenant}).encode()
        budget = min(self.forward_timeout, self._local.reply_timeout)
        if deadline is not None:
            budget = min(budget, deadline.remaining())
        req = _PendingRequest(
            id=uuid.uuid4().hex, method="POST", path=self.api_path,
            headers={}, body=body, deadline=Deadline.after(budget),
            admitted_at=time.monotonic(),
            # the fast path pins the active (tenant, version) exactly like
            # the worker's own admission path (hot-swap consistency)
            handler=(self._local.handler if tenant is None
                     else self._local.handler_for(tenant)),
            tenant=tenant if tenant is not None else DEFAULT_TENANT)
        try:
            self._local._queue.put_nowait(req)
        except queue.Full:
            # the local worker's bounded admission queue applies to the
            # fast path too — a full queue reads as an overloaded worker
            # and the sibling retry takes over
            raise ConnectionError("local serving worker queue full")
        # the gateway's failover bound applies here exactly as it does to an
        # HTTP forward — a wedged local serve loop must not stall requests
        # past forward_timeout before the sibling retry
        if not req.reply_event.wait(budget):
            raise TimeoutError("local worker reply timeout")
        status, _headers, payload = req.response
        return status, payload

    # --- embedded public server ----------------------------------------
    def start(self) -> "ServingGateway":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True
            timeout = 30

            def _reply_json(self, status: int, payload: bytes):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                if self.path.startswith(FABRIC_PATH_PREFIX):
                    status, resp = outer._handle_control(self.path, body)
                    self._reply_json(status, _json.dumps(resp).encode())
                    return
                fwd_headers = {"Content-Type": self.headers.get(
                    "Content-Type", "application/json"),
                    "Content-Length": str(len(body))}
                tenant = self.headers.get(TENANT_HEADER)
                if tenant:
                    tenant = tenant.strip() or None
                if tenant:
                    # the tenant identity rides every hop: the worker's own
                    # QoS admission and handler pinning key on it
                    fwd_headers[TENANT_HEADER] = tenant
                if tenant is not None and outer.qos is not None:
                    # edge-tier admission at the gateway boundary: this
                    # gateway's leased share of the tenant's GLOBAL rate
                    # (federation lease math) — shed here costs no
                    # forward hop and no worker handler time
                    decision = outer.edge_admit(tenant)
                    if not decision.ok:
                        self._reply_json(decision.status, _json.dumps(
                            {"error": decision.reason,
                             "tenant": tenant}).encode())
                        return
                # no header -> no gateway deadline (forward_timeout already
                # bounds each attempt; a synthetic deadline equal to it
                # would starve the sibling retry). An explicit budget is
                # capped at the gateway's own total-work bound.
                raw = self.headers.get(DEADLINE_HEADER)
                with outer._lock:
                    n_links = max(len(outer.links), 1)
                cap = outer.forward_timeout * (
                    outer._max_retries_cfg
                    if outer._max_retries_cfg is not None else n_links)
                deadline = (None if raw is None
                            else Deadline.from_header_ms(raw, cap))
                status, payload = outer._forward(
                    "POST", outer.api_path, body, fwd_headers,
                    deadline=deadline,
                    hint=outer._shape_hint(body, self.headers),
                    tenant=tenant)
                self._reply_json(status, payload)

            def do_GET(self):  # noqa: N802  — health/stats endpoint
                outer._sweep_expired()
                now = outer._clock()
                with outer._lock:
                    links = list(outer.links)
                body = _json.dumps({
                    "workers": [l.health(now) for l in links],
                    "membership": outer.membership.snapshot(now),
                    "mode": outer.mode,
                    "federation": outer.federation_snapshot(),
                    **outer.stats.snapshot()}).encode()
                self._reply_json(200, body)

            def log_message(self, *args):
                pass

        class _Server(ThreadingHTTPServer):
            request_queue_size = 256
            daemon_threads = True

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        # assigned exactly once, before the serve/replicator threads exist;
        # read-only afterwards (start() happens-before both thread starts)
        self.public_url = f"http://{self.host}:{self.port}"  # lint-ok: thread-shared write precedes thread start
        self.ring.add(self.public_url)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        if self.federated:
            self._start_replicator()
        return self

    def stop(self) -> None:
        self._repl_stop.set()
        if self._repl_thread is not None:
            self._repl_thread.join(timeout=self.gossip_interval + 1.0)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}{self.api_path}"

    @property
    def control_url(self) -> str:
        """Base of the membership control plane (heartbeats POST here)."""
        return f"http://{self.host}:{self.port}{FABRIC_PATH_PREFIX}"

    def __enter__(self) -> "ServingGateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def federate(gateways: Sequence[ServingGateway]) -> None:
    """Wire started gateways into one federated tier: every gateway learns
    every other as a gossip peer, starting the anti-entropy replicators.
    After convergence (a few ``gossip_interval`` ticks) any gateway routes
    to any worker, tenant homes agree fabric-wide, and per-tenant budgets
    are enforced as leased shares of one global contract."""
    for gw in gateways:
        for other in gateways:
            if other is not gw:
                gw.add_peer(f"http://{other.host}:{other.port}")


class WorkerAgent:
    """Worker-side membership reporter: a daemon thread POSTing periodic
    heartbeats to the gateway's control plane. Each beat advertises the
    worker's reachable url, queue depth, warmed bucket ladder
    (``BucketedRunner.warm_buckets()`` when the handler exposes a runner),
    and active model version (when a ``ModelRegistry`` is attached) — the
    inputs to the gateway's bucket-aware routing and the
    :class:`FabricSupervisor`'s scaling decisions.

    Failure model: a failed beat (gateway down, partition) is COUNTED and
    otherwise ignored — the worker keeps serving and keeps beating, so a
    healed partition rejoins automatically. ``stop()`` sends a best-effort
    deregister (clean leave) unless ``deregister=False``.

    **Gateway failover**: ``gateway_url`` may be a list, and every
    heartbeat ack carries the live gateway set (federation gossip), which
    the agent learns. When the primary gateway is unreachable the SAME
    beat retries against each other known gateway with jittered backoff
    (thundering-herd protection when a whole fleet rehomes at once); the
    first gateway that acks becomes the new primary — a dead gateway
    re-homes its workers within one heartbeat interval instead of
    silently orphaning them. ``failed`` counts beats NO gateway took;
    ``failed_over`` counts re-homings.
    """

    def __init__(self, worker: ServingServer,
                 gateway_url: Union[str, Sequence[str]],
                 advertise_url: Optional[str] = None,
                 worker_id: Optional[str] = None,
                 interval: float = 0.5, timeout: float = 2.0,
                 failover_backoff: float = 0.05):
        urls = [gateway_url] if isinstance(gateway_url, str) \
            else list(gateway_url)
        if not urls:
            raise ValueError("WorkerAgent needs at least one gateway url")
        self._gw_lock = threading.Lock()
        self._controls: List[str] = []
        for u in urls:
            base = self._control_base(u)
            if base not in self._controls:
                self._controls.append(base)
        self._primary = 0
        self.failover_backoff = failover_backoff
        self.worker = worker
        wh, wp = _parse_hostport(advertise_url or worker.url)
        self.advertise_url = f"http://{wh}:{wp}"
        self.worker_id = worker_id or uuid.uuid4().hex[:12]
        self.interval = interval
        self.timeout = timeout
        self.sent = 0
        self.dropped = 0          # chaos-partitioned beats
        self.failed = 0           # beats no known gateway acknowledged
        self.failed_over = 0      # beats that re-homed to another gateway
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _control_base(url: str) -> str:
        h, p = _parse_hostport(url)
        return f"http://{h}:{p}{FABRIC_PATH_PREFIX}"

    @property
    def _control(self) -> str:
        """Primary control endpoint (back-compat read surface)."""
        with self._gw_lock:
            return self._controls[self._primary]

    def gateways(self) -> List[str]:
        with self._gw_lock:
            return list(self._controls)

    def _learn_peers(self, ack: dict) -> None:
        """Fold the gateway's advertised live-peer set into the failover
        list — a worker pointed at ONE federated gateway learns the rest
        from its first ack."""
        peers = ack.get("peers")
        if not isinstance(peers, list):
            return
        for u in peers:
            try:
                base = self._control_base(str(u))
            except (TypeError, ValueError):
                continue
            with self._gw_lock:
                if base not in self._controls:
                    self._controls.append(base)

    def payload(self) -> dict:
        p = {"id": self.worker_id, "url": self.advertise_url,
             "queue_depth": int(self.worker._queue.qsize())}
        runner = getattr(self.worker.handler, "runner", None)
        if runner is not None and callable(
                getattr(runner, "warm_buckets", None)):
            try:
                p["warm_buckets"] = [int(b) for b in runner.warm_buckets()]
            except Exception:  # noqa: BLE001 — advertisement is advisory
                pass
        registry = getattr(self.worker, "registry", None)
        if registry is not None:
            p["version"] = registry.active
        # per-(tenant, model) advertisement: each tenant's active version
        # and warm graph ladder, so the gateway can route (tenant, shape) →
        # warmest replica and spot mixed-version fabrics per tenant
        tenants = {}
        for t, h in dict(self.worker.tenant_handlers).items():
            entry: dict = {}
            reg = self.worker.registries.get(t)
            if reg is not None:
                entry["version"] = reg.active
            runner = getattr(h, "runner", None)
            if runner is not None and callable(
                    getattr(runner, "warm_buckets", None)):
                try:
                    entry["warm_buckets"] = [
                        int(b) for b in runner.warm_buckets()]
                except Exception:  # noqa: BLE001 — advisory
                    pass
            tenants[t] = entry
        if tenants:
            p["tenants"] = tenants
        return p

    def _post(self, op: str, payload: dict) -> dict:
        return self._post_to(self._control, op, payload)

    def _post_to(self, control: str, op: str, payload: dict) -> dict:
        import urllib.request

        req = urllib.request.Request(
            control + op, data=_json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            raw = r.read()
        try:
            ack = _json.loads(raw.decode())
        except ValueError:
            ack = {}
        return ack if isinstance(ack, dict) else {}

    def beat(self) -> bool:
        """One heartbeat. Returns True when A gateway acknowledged it;
        False for a chaos-dropped beat or when every known gateway is
        unreachable (both benign: the next beat retries and a healed
        partition rejoins). On primary-gateway failure the beat fails over
        through the other known gateways with jittered backoff; the first
        responder becomes the new primary."""
        hook = _HEARTBEAT_HOOK
        if hook is not None and not hook(self.worker_id):
            self.dropped += 1
            return False
        payload = self.payload()
        with self._gw_lock:
            primary = self._primary
            order = [primary] + [i for i in range(len(self._controls))
                                 if i != primary]
            controls = list(self._controls)
        for attempt, idx in enumerate(order):
            if attempt:
                # jittered backoff between failover attempts: a dead
                # gateway rehomes a whole fleet at once, and the jitter
                # spreads the stampede across the survivors
                time.sleep(random.uniform(0.5, 1.5)
                           * self.failover_backoff)
            try:
                ack = self._post_to(controls[idx], "heartbeat", payload)
            except Exception:  # noqa: BLE001 — gateway down != worker down
                continue
            if idx != primary:
                with self._gw_lock:
                    self._primary = idx
                self.failed_over += 1
                record_failure("fabric.heartbeat_failover",
                               worker=self.worker_id,
                               gateway=controls[idx])
            self.sent += 1
            self._learn_peers(ack)
            return True
        self.failed += 1
        return False

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.beat()
            self._stop.wait(self.interval)

    def start(self) -> "WorkerAgent":
        self.beat()                        # eager join before first interval
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, deregister: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + self.timeout)
        if deregister:
            # best-effort clean leave, trying each known gateway once
            for control in self.gateways():
                try:
                    self._post_to(control, "deregister",
                                  {"url": self.advertise_url})
                    break
                except Exception:  # noqa: BLE001
                    continue

    def __enter__(self) -> "WorkerAgent":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class FabricSupervisor:
    """Queue-depth-driven autoscaling hook over a running gateway.

    The membership layer makes scaling possible (workers join/leave a live
    gateway); this supervisor makes it a policy: when the mean advertised
    queue depth across alive workers exceeds ``scale_up_depth`` it calls
    ``spawn_fn()`` (user-supplied: start a process, schedule a pod — the
    new worker's own heartbeat joins it), and when depth falls below
    ``scale_down_depth`` with more than ``min_workers`` alive it calls
    ``retire_fn(url)`` with the least-loaded worker (whose agent then
    drains and deregisters). ``decide()`` is pure — deterministic to test —
    and ``step()`` applies one decision; ``start()`` runs steps on a daemon
    thread for deployments that want the loop managed here.
    """

    def __init__(self, gateway: ServingGateway,
                 spawn_fn: Callable[[], object],
                 retire_fn: Optional[Callable[[str], object]] = None,
                 min_workers: int = 1, max_workers: int = 8,
                 scale_up_depth: float = 4.0, scale_down_depth: float = 0.5,
                 interval: float = 1.0):
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError("need 1 <= min_workers <= max_workers")
        if scale_down_depth >= scale_up_depth:
            raise ValueError("scale_down_depth must be < scale_up_depth "
                             "(hysteresis band)")
        self.gateway = gateway
        self.spawn_fn = spawn_fn
        self.retire_fn = retire_fn
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.scale_up_depth = scale_up_depth
        self.scale_down_depth = scale_down_depth
        self.interval = interval
        self.spawned = 0
        self.retired = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def observe(self) -> Tuple[int, float]:
        """(alive workers, mean advertised queue depth)."""
        with self.gateway._lock:
            links = list(self.gateway.links)
        if not links:
            return 0, 0.0
        depths = [l.queue_depth for l in links]
        return len(links), sum(depths) / len(depths)

    def decide(self, n_alive: int, mean_depth: float) -> Optional[str]:
        """Pure scaling policy: "up", "down", or None (hysteresis band)."""
        if n_alive < self.min_workers:
            return "up"
        if mean_depth > self.scale_up_depth and n_alive < self.max_workers:
            return "up"
        if mean_depth < self.scale_down_depth and n_alive > self.min_workers:
            return "down" if self.retire_fn is not None else None
        return None

    def step(self) -> Optional[str]:
        """Observe -> decide -> act once; returns the action taken. Each
        step also runs the explicit membership sweep — the supervisor is
        the "own cadence" caller :meth:`ServingGateway.evict_stale` needs
        so an idle fabric still decays dead workers."""
        self.gateway.evict_stale()
        n, depth = self.observe()
        action = self.decide(n, depth)
        if action == "up":
            self.spawn_fn()
            self.spawned += 1
            record_failure("gateway.scale_up", workers=n,
                           mean_depth=round(depth, 3))
        elif action == "down":
            with self.gateway._lock:
                idle = sorted(self.gateway.links,
                              key=lambda l: (l.queue_depth, l.inflight))
            victim = next((l for l in idle
                           if l is not self.gateway._local_link), None)
            if victim is None:
                return None
            self.retire_fn(victim.url)
            self.retired += 1
            record_failure("gateway.scale_down", worker=victim.url,
                           mean_depth=round(depth, 3))
        return action

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:  # noqa: BLE001 — a bad spawn must not kill
                record_failure("gateway.supervisor_error")  # the loop
            self._stop.wait(self.interval)

    def start(self) -> "FabricSupervisor":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1.0)


class BroadcastError(RuntimeError):
    """A fabric-wide promotion broadcast failed AND recovery converged the
    fabric back to the old version (or could not complete at all). Either
    way no worker is left on a half-promoted version — the error reports
    that the NEW version did not take, not that the fabric is mixed."""


class CoordinatorDied(RuntimeError):
    """The gateway coordinating a promotion broadcast died mid-round
    (chaos ``kill_gateway``). The dead coordinator performs NO cleanup —
    its thread unwinds with registries possibly mixed between staged and
    committed. The round is NOT lost: its phase record is replicated
    control-plane state, and a surviving peer's
    :meth:`PromotionBroadcast.recover` reads it and drives the round to
    commit or abort (never leaving workers split across versions)."""


class PromotionBroadcast:
    """Two-phase fabric-wide promotion: one gate approval flips EVERY
    worker's registry to the same version, atomically per worker, with no
    mixed-version fabric on any failure path.

    Phase 1 — **prepare**: each worker's :class:`~synapseml_tpu_torch.io.serving.
    ModelRegistry` stages and warms (captures) the candidate OFF its hot path
    (:meth:`ModelRegistry.prepare`), holding its swap lock so racing
    single-shot swaps lose deterministically. Any prepare failure aborts
    every already-prepared worker → the fabric never left the old version.

    Phase 2 — **commit**: each worker flips (:meth:`ModelRegistry.commit`).
    A commit failure (injected kill at the ``commit`` swap-point) leaves
    that worker's version STAGED with the lock held, so the broadcast first
    retries the commit (kill-once chaos converges forward: all workers on
    the NEW version). If a worker still cannot commit, recovery converges
    BACKWARD instead: its stage is aborted and every already-committed
    worker rolls back — all workers on the OLD gate-approved version.

    **Coordinator death** (federated mode): pass ``control`` (a
    :class:`~synapseml_tpu_torch.core.gossip.GossipState` — any publish/items/
    entry surface) and ``alive`` (a liveness probe for the coordinating
    gateway, e.g. ``gw.alive``). The round's phase then replicates as a
    ``promo/<version>`` record at every 2PC transition (``preparing`` →
    ``prepared`` → ``committed``/``aborted``), and the coordinator checks
    ``alive()`` before each per-worker step — a chaos kill raises
    :class:`CoordinatorDied` mid-round, leaving registries mixed between
    staged (swap lock stranded in the dead thread) and committed. A
    surviving peer holding the replicated record calls :meth:`recover`:
    the ``prepared`` decision record drives the round FORWARD (adopt each
    orphaned stage via :meth:`ModelRegistry.take_over_staged`, commit),
    while a round still ``preparing`` converges BACKWARD (adopt + abort,
    roll back any commits) — either way exactly one version serves
    fabric-wide. Without ``control`` the single-coordinator behavior is
    unchanged: per-worker atomicity is the chaos-tested floor.
    """

    def __init__(self, registries: Sequence[ModelRegistry],
                 commit_retries: int = 1, control=None,
                 node_id: str = "coordinator",
                 alive: Optional[Callable[[], bool]] = None):
        if not registries:
            raise ValueError("broadcast needs at least one registry")
        self.registries = list(registries)
        self.commit_retries = commit_retries
        self.control = control
        self.node_id = node_id
        self.alive = alive
        self.broadcasts = 0
        self.aborted = 0
        self.rolled_back = 0
        self.recoveries = 0

    def _record_phase(self, version: str, phase: str) -> None:
        if self.control is not None:
            self.control.publish(
                f"promo/{version}",
                {"phase": phase, "version": version,
                 "coordinator": self.node_id,
                 "workers": len(self.registries)})

    def _check_alive(self, version: str) -> None:
        if self.alive is not None and not self.alive():
            record_failure("gateway.broadcast_coordinator_died",
                           version=version)
            raise CoordinatorDied(
                f"coordinating gateway died mid-broadcast of {version!r}; "
                "a surviving peer must recover the round from its "
                "replicated phase record")

    def active_versions(self) -> List[str]:
        return [r.active for r in self.registries]

    def converged(self) -> bool:
        """All workers on one version — the no-mixed-fabric invariant."""
        return len(set(self.active_versions())) == 1

    def broadcast(self, version: str, handler: Callable,
                  warmup: bool = True) -> str:
        old = {id(r): r.active for r in self.registries}
        prepared: List[ModelRegistry] = []
        self._record_phase(version, "preparing")
        try:
            for reg in self.registries:
                self._check_alive(version)
                reg.prepare(version, handler, warmup=warmup)
                prepared.append(reg)
        except CoordinatorDied:
            # the dead coordinator does NO cleanup (its process is gone);
            # the replicated "preparing" record tells a surviving peer to
            # converge the round backward
            raise
        except Exception as e:  # noqa: BLE001 — abort-all: old version holds
            for reg in prepared:
                reg.abort()
            self.aborted += 1
            self._record_phase(version, "aborted")
            record_failure("gateway.broadcast_aborted", version=version,
                           stage="prepare", error=type(e).__name__)
            raise BroadcastError(
                f"prepare of {version!r} failed on worker "
                f"{len(prepared)}/{len(self.registries)} "
                f"({type(e).__name__}: {e}); every worker is still on its "
                "old version") from e
        # every worker is staged: the 2PC decision point. The replicated
        # "prepared" record IS the commit decision — a surviving peer that
        # reads it drives the round forward even if we die on the next line
        self._record_phase(version, "prepared")
        committed: List[ModelRegistry] = []
        failed: List[ModelRegistry] = []
        for reg in self.registries:
            self._check_alive(version)     # CoordinatorDied mid-commit
            for attempt in range(1 + self.commit_retries):
                try:
                    reg.commit(version)
                    committed.append(reg)
                    break
                except Exception as e:  # noqa: BLE001
                    record_failure("gateway.broadcast_commit_retry",
                                   version=version,
                                   error=type(e).__name__)
                    if attempt == self.commit_retries:
                        failed.append(reg)
        if not failed:
            self.broadcasts += 1
            self._record_phase(version, "committed")
            record_failure("gateway.broadcast_completed", version=version,
                           workers=len(self.registries))
            return version
        # backward convergence: some worker cannot take the new version —
        # abort its stage and roll every committed worker back, so the
        # fabric converges on ONE (old, gate-approved) version
        for reg in failed:
            reg.abort()
        for reg in committed:
            try:
                prev = old[id(reg)]
                reg.swap_to(prev, reg.versions[prev], warmup=False)
            except Exception:  # noqa: BLE001 — best effort; chaos-bounded
                record_failure("gateway.broadcast_rollback_failed",
                               version=version)
        self.rolled_back += 1
        self._record_phase(version, "aborted")
        record_failure("gateway.broadcast_rolled_back", version=version,
                       failed=len(failed))
        raise BroadcastError(
            f"commit of {version!r} failed on {len(failed)} worker(s); "
            "fabric rolled back to the old version")

    # -- surviving-peer recovery -----------------------------------------
    def in_doubt(self) -> Optional[Tuple[str, str]]:
        """(version, phase) of the newest round left in doubt by a dead
        coordinator — phase ``preparing`` or ``prepared`` — else None."""
        if self.control is None:
            return None
        pending = []
        for key, rec in self.control.items("promo/").items():
            if rec.get("phase") in ("preparing", "prepared"):
                entry = self.control.entry(key)
                pending.append((entry.epoch if entry is not None else 0,
                                str(rec.get("version", "")),
                                str(rec["phase"])))
        if not pending:
            return None
        _, version, phase = max(pending)
        return version, phase

    def recover(self) -> Optional[Tuple[str, str]]:
        """Drive a dead coordinator's in-doubt round to its end from the
        replicated phase record; returns ``(version, outcome)`` with
        outcome ``"committed"`` or ``"aborted"``, or None when no round
        needs recovery. Called by a surviving peer gateway (same registry
        set, converged control plane). A ``prepared`` record means every
        worker staged and the decision to commit was made: adopt each
        orphaned stage (:meth:`ModelRegistry.take_over_staged` — legal
        only because the owning thread is dead) and commit it. A round
        still ``preparing`` never decided: abort every stage and roll
        back any stray commit. Either way the fabric ends on exactly one
        version, and the final phase replicates so other survivors do not
        re-recover the same round."""
        pending = self.in_doubt()
        if pending is None:
            return None
        version, phase = pending
        record_failure("gateway.broadcast_recovery", version=version,
                       phase=phase)
        if phase == "prepared":
            outcome = self._recover_forward(version)
        else:
            outcome = self._recover_backward(version)
        self.recoveries += 1
        self._record_phase(version, outcome)
        record_failure("gateway.broadcast_recovered", version=version,
                       outcome=outcome)
        return version, outcome

    def _recover_forward(self, version: str) -> str:
        stranded: List[ModelRegistry] = []
        for reg in self.registries:
            if reg.active == version:
                continue            # the coordinator committed this one
            try:
                if reg.take_over_staged():
                    reg.commit(version)
                else:
                    stranded.append(reg)    # no stage, not active
            except Exception:  # noqa: BLE001 — converge backward below
                stranded.append(reg)
        if not stranded:
            self.broadcasts += 1
            return "committed"
        return self._recover_backward(version)

    def _recover_backward(self, version: str) -> str:
        for reg in self.registries:
            try:
                if reg.take_over_staged():
                    reg.abort()
            except Exception:  # noqa: BLE001 — a live owner keeps its lock
                record_failure("gateway.broadcast_recovery_skip",
                               version=version)
            if reg.active == version:
                # committed before the coordinator died: roll back so the
                # fabric converges on the OLD gate-approved version
                try:
                    reg.rollback()
                except Exception:  # noqa: BLE001
                    record_failure("gateway.broadcast_rollback_failed",
                                   version=version)
        self.aborted += 1
        return "aborted"


class DistributedServingServer:
    """Fabric-wide serving: every process starts a worker ServingServer
    running ``handler`` on its card; worker addresses are exchanged over the
    ``torch.distributed`` world (the rendezvous the reference does through
    Spark's driver); process 0 additionally exposes the public gateway, and
    every process runs a :class:`WorkerAgent` heartbeating to it — so the
    fabric started static becomes dynamic the moment it is up (dead workers
    evict, restarted ones rejoin, new ones may join).

    The world is the multi-controller one that
    ``parallel.initialize_distributed`` joins: ``process_count()`` processes,
    this one ``process_index()``. Single-process fallback: outside such a
    world this degrades to one worker + gateway on the same host (still
    exercising the forwarding hop and the heartbeat loop).
    """

    def __init__(self, handler: Callable[[Table], Table],
                 host: Optional[str] = None, gateway_port: int = 0,
                 worker_port: int = 0, mode: str = "least_loaded",
                 max_batch_size: int = 64, max_batch_latency: float = 0.0,
                 advertise_host: Optional[str] = None,
                 heartbeat_interval: float = 0.5,
                 heartbeat_timeout: float = 3.0):
        self.handler = handler
        # None = auto: loopback single-process; all interfaces when the
        # advertised address must be reachable from OTHER hosts
        self.host = host
        # multi-process: the address OTHER processes reach this worker at
        # (default: auto-detected routable interface address)
        self.advertise_host = advertise_host
        self.gateway_port = gateway_port
        self.worker_port = worker_port
        self.mode = mode
        self.max_batch_size = max_batch_size
        self.max_batch_latency = max_batch_latency
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.worker: Optional[ServingServer] = None
        self.gateway: Optional[ServingGateway] = None
        self.agent: Optional[WorkerAgent] = None

    _local_ip = staticmethod(_detect_local_ip)

    def _advertised_octets(self) -> List[int]:
        """This process's advertised IPv4 address as 4 octets.

        Constraint: the advertised address must be an IPv4 dotted-quad (it
        ships as exactly 4 octets on the wire). IPv6 and hostnames are
        rejected with a clear error instead of silently mangling the
        address — resolve the name / pick the v4 interface address first."""
        import socket

        ip = self.advertise_host or self._local_ip()
        try:
            return [int(b) for b in socket.inet_aton(ip)]
        except OSError as e:
            raise ValueError(
                f"advertise_host {ip!r} is not an IPv4 dotted-quad address; "
                "the worker-address exchange ships exactly 4 octets over "
                "the collective wire, so IPv6 addresses and hostnames are "
                "not supported here — pass the host's IPv4 interface "
                "address (e.g. advertise_host='10.0.0.12'), resolving any "
                "hostname yourself first") from e

    @staticmethod
    def _allgather_rows(row: List[int]) -> List[List[int]]:
        """Every process's ``row`` (ints) in process order: one CPU
        all-gather over the ``torch.distributed`` world."""
        import torch
        import torch.distributed as dist

        local = torch.tensor(row, dtype=torch.int64)
        got = [torch.empty_like(local)
               for _ in range(dist.get_world_size())]
        dist.all_gather(got, local)
        return [[int(v) for v in g] for g in got]

    def _gather_worker_addrs(self, port: int) -> List[str]:
        """All-gather (ip, port) across processes. The address rides a tiny
        int row through the collective layer — the only cross-process
        exchange serving needs (requests themselves flow over plain
        HTTP)."""
        if process_count() == 1:
            return [f"http://{self.host or '127.0.0.1'}:{port}"]
        rows = self._allgather_rows(self._advertised_octets() + [port])
        return [f"http://{a}.{b}.{c}.{d}:{p}" for a, b, c, d, p in rows]

    def start(self) -> "DistributedServingServer":
        multi = process_count() > 1
        bind = self.host or ("0.0.0.0" if multi else "127.0.0.1")
        self.worker = ServingServer(
            self.handler, host=bind, port=self.worker_port,
            max_batch_size=self.max_batch_size,
            max_batch_latency=self.max_batch_latency).start()
        urls = self._gather_worker_addrs(self.worker.port)
        if process_index() == 0:
            self.gateway = ServingGateway(
                urls, host=bind, port=self.gateway_port,
                mode=self.mode, local_worker=self.worker,
                local_index=process_index(),
                heartbeat_timeout=self.heartbeat_timeout).start()
        # every process learns the gateway address (process 0's advertised
        # ip + the resolved gateway port) and starts heartbeating to it
        gw_url = self._gather_gateway_url()
        if gw_url is not None:
            self.agent = WorkerAgent(
                self.worker, gw_url,
                advertise_url=urls[process_index()],
                interval=self.heartbeat_interval).start()
        return self

    def _gather_gateway_url(self) -> Optional[str]:
        """Gateway address on every process: process 0 contributes its
        advertised ip + gateway port; everyone takes row 0."""
        if process_count() == 1:
            return self.gateway.url if self.gateway is not None else None
        port = self.gateway.port if self.gateway is not None else 0
        a, b, c, d, p = self._allgather_rows(
            self._advertised_octets() + [port])[0]
        return f"http://{a}.{b}.{c}.{d}:{p}"

    def stop(self) -> None:
        if self.agent is not None:
            self.agent.stop()
        if self.gateway is not None:
            self.gateway.stop()
        if self.worker is not None:
            self.worker.stop()

    @property
    def url(self) -> str:
        """Public endpoint (gateway on process 0, else the local worker)."""
        if self.gateway is not None:
            return self.gateway.url
        return self.worker.url

    def __enter__(self) -> "DistributedServingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
