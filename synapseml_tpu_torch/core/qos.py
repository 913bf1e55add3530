"""Per-tenant QoS: token-bucket admission, weighted-fair dequeue, and
tenant quarantine for the multi-tenant serving server.

A copy of the JAX package's ``core/qos.py`` (pure host-side control plane;
it imports no JAX). Several models share one serving process; this module
is the isolation boundary, layered on top of the bounded admission and
shedding of ``io/serving.py``:

* :class:`QoSClass` — a named admission contract (token-bucket rate/burst,
  weighted-fair share, per-tenant queue bound, quarantine thresholds).
* :class:`QoSController` — per-tenant state keyed by the ``X-Tenant``
  header: a token bucket gating admission (exhausted → **429**), a
  per-tenant :class:`~synapseml_tpu_torch.core.resilience.CircuitBreaker`
  fed by handler failures and non-finite replies (open → **quarantined**,
  requests shed at **503** without costing handler time), and per-tenant
  failure/served counters.
* :class:`BudgetLeaseLedger` — the per-tenant rate leases of federated
  gateways (kept with the module; its gateway is not ported yet).
* :class:`WeightedFairQueue` — the admission queue of a QoS-enabled
  server: per-tenant FIFO lanes drained by virtual-time weighted-fair
  scheduling, each lane bounded on its own. It implements the
  ``queue.Queue`` subset ``io/serving.py`` consumes
  (``put_nowait``/``get``/``get_nowait``/``qsize``/``empty``).

Everything is thread-safe and clock-injectable (tests drive fake clocks).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

from .logging import record_failure
from .resilience import CircuitBreaker

#: Tenant id carried by requests; absent → DEFAULT_TENANT.
TENANT_HEADER = "X-Tenant"
DEFAULT_TENANT = "default"


@dataclass(frozen=True)
class QoSClass:
    """One admission contract. ``rate_per_sec=None`` means un-rate-limited
    (the queue bound and quarantine still apply). ``weight`` is the
    weighted-fair share of batch-formation dequeues; ``max_queue`` bounds
    the tenant's own admission lane."""

    name: str = "standard"
    rate_per_sec: Optional[float] = None
    burst: float = 64.0
    weight: float = 1.0
    max_queue: int = 256
    #: consecutive handler failures (thrown / 500 / non-finite reply) that
    #: quarantine the tenant, and the cooldown before one probe request is
    #: readmitted (CircuitBreaker semantics: escalating on re-trips).
    quarantine_threshold: int = 5
    quarantine_cooldown: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.burst <= 0:
            raise ValueError(f"burst must be > 0, got {self.burst}")


@dataclass(frozen=True)
class AdmitDecision:
    """Outcome of one admission check. ``status`` is the HTTP status the
    server replies with when ``ok`` is False (429 rate-limited at the
    tenant's own token bucket, 503 quarantined at the tenant's own breaker
    boundary)."""

    ok: bool
    status: int = 200
    reason: str = "admitted"


class _TenantState:
    """Per-tenant bucket + breaker + counters; guarded by the controller
    lock (single writer discipline — the controller takes its lock around
    every mutation)."""

    def __init__(self, qos: QoSClass, clock):
        self.qos = qos
        self.tokens = float(qos.burst)
        self.last_refill = clock()
        self.breaker = CircuitBreaker(
            failure_threshold=qos.quarantine_threshold,
            cooldown=qos.quarantine_cooldown, clock=clock)
        self.admitted = 0
        self.rate_limited = 0
        self.quarantined = 0
        self.completed = 0
        self.failed = 0
        self.nonfinite = 0

    # called with the controller's _lock held (see class docstring)
    def refill(self, now: float, share: float = 1.0) -> None:
        """Refill at ``share`` of the class contract. ``share`` < 1 is the
        federated mode: the class rate/burst describe the GLOBAL per-tenant
        budget and each gateway enforces its leased fraction, so K gateways
        admitting independently still sum to one global rate (burst floors
        at one token — a leaseholder must always be able to admit)."""
        rate = self.qos.rate_per_sec
        burst = max(1.0, self.qos.burst * share)
        if rate is None:
            self.tokens = burst  # lint-ok: locks
        else:
            self.tokens = min(  # lint-ok: locks
                burst,
                self.tokens + (now - self.last_refill) * rate * share)
        self.last_refill = now


class QoSController:
    """Keyed per-tenant admission/quarantine state. One instance per
    :class:`~synapseml_tpu_torch.io.serving.ServingServer`; the server calls
    :meth:`admit` at its admission boundary and feeds batch outcomes back
    through :meth:`record_success` / :meth:`record_failure`."""

    def __init__(self, default_class: Optional[QoSClass] = None,
                 classes: Optional[Dict[str, QoSClass]] = None,
                 clock=time.monotonic):
        self.default_class = default_class or QoSClass()
        self._clock = clock
        self._lock = threading.Lock()
        self._classes: Dict[str, QoSClass] = dict(classes or {})
        self._tenants: Dict[str, _TenantState] = {}
        # federated budget leasing: tenant -> this enforcer's fraction of
        # the GLOBAL class rate (1.0 = sole enforcer, the single-gateway
        # mode). Written by set_rate_share from the gossip/lease layer.
        self._shares: Dict[str, float] = {}

    def assign(self, tenant: str, qos: QoSClass) -> None:
        """(Re)assign a tenant's QoS class; existing counters are kept but
        the bucket and breaker restart under the new contract."""
        with self._lock:
            self._classes[tenant] = qos
            old = self._tenants.pop(tenant, None)
            state = self._state_locked(tenant)
            if old is not None:
                for c in ("admitted", "rate_limited", "quarantined",
                          "completed", "failed", "nonfinite"):
                    setattr(state, c, getattr(old, c))

    def qos_class(self, tenant: str) -> QoSClass:
        with self._lock:
            return self._classes.get(tenant, self.default_class)

    # -- federated budget leasing --
    def set_rate_share(self, tenant: str, share: float) -> None:
        """Set this enforcer's leased fraction of the tenant's GLOBAL
        rate/burst contract (:class:`BudgetLeaseLedger` computes it from
        live leaseholders). Clamped to (0, 1]; takes effect on the next
        refill — tokens already granted are honored (a shrinking share
        never claws back admitted requests)."""
        share = min(max(float(share), 1e-9), 1.0)
        with self._lock:
            self._shares[tenant] = share

    def rate_share(self, tenant: str) -> float:
        with self._lock:
            return self._shares.get(tenant, 1.0)

    def _state_locked(self, tenant: str) -> _TenantState:
        state = self._tenants.get(tenant)
        if state is None:
            state = _TenantState(
                self._classes.get(tenant, self.default_class), self._clock)
            self._tenants[tenant] = state
        return state

    # -- admission boundary --
    def admit(self, tenant: str) -> AdmitDecision:
        """One admission check: quarantine first (a quarantined tenant's
        requests must not drain its token bucket — readmission is the
        breaker's single half-open probe), then the token bucket."""
        now = self._clock()
        with self._lock:
            state = self._state_locked(tenant)
            if not state.breaker.try_acquire(now):
                state.quarantined += 1
                record_failure("qos.quarantined", tenant=tenant)
                return AdmitDecision(False, 503, "quarantined")
            state.refill(now, self._shares.get(tenant, 1.0))
            if state.tokens < 1.0:
                state.rate_limited += 1
                # the failed admission must not hold the half-open probe
                # slot hostage: a rate-limited probe is not a verdict on
                # the tenant's handler
                if state.breaker.state == CircuitBreaker.HALF_OPEN:
                    state.breaker._probe_inflight = False
                record_failure("qos.rate_limited", tenant=tenant)
                return AdmitDecision(False, 429, "rate_limited")
            state.tokens -= 1.0
            state.admitted += 1
            return AdmitDecision(True)

    # -- outcome feedback (fed by the server's batch path) --
    def record_success(self, tenant: str, n: int = 1) -> None:
        with self._lock:
            state = self._state_locked(tenant)
            state.completed += n
        state.breaker.record_success()

    def record_failure(self, tenant: str, n: int = 1,
                       nonfinite: bool = False) -> None:
        """Count ``n`` handler failures for a tenant; each feeds the
        quarantine breaker (consecutive failures past the class threshold
        OPEN it and the tenant sheds at its own 503 boundary)."""
        with self._lock:
            state = self._state_locked(tenant)
            state.failed += n
            if nonfinite:
                state.nonfinite += n
        for _ in range(n):
            state.breaker.record_failure()
        record_failure("qos.tenant_failure", n=n, tenant=tenant,
                       nonfinite=bool(nonfinite))

    def is_quarantined(self, tenant: str) -> bool:
        now = self._clock()
        with self._lock:
            state = self._tenants.get(tenant)
        return state is not None and not state.breaker.available(now)

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for tenant, s in self._tenants.items():
                out[tenant] = {
                    "class": s.qos.name, "weight": s.qos.weight,
                    "tokens": round(s.tokens, 3),
                    "rate_share": self._shares.get(tenant, 1.0),
                    "admitted": s.admitted,
                    "rate_limited": s.rate_limited,
                    "quarantined": s.quarantined,
                    "completed": s.completed, "failed": s.failed,
                    "nonfinite": s.nonfinite,
                    "breaker": s.breaker.snapshot()}
            return out


class BudgetLeaseLedger:
    """Who currently holds a sub-budget lease on each tenant's global rate.

    The federated-gateway problem: K edge gateways must together enforce
    ONE per-tenant rate without a central counter on the hot path. Scheme:
    a gateway serving tenant T claims a **lease** — a gossip entry
    (``lease/<tenant>/<gateway>``) it re-publishes every replicator tick.
    Every gateway feeds the lease entries it sees (its own and merged ones)
    into this ledger via :meth:`observe`; a leaseholder is **live** while
    its entry keeps advancing, judged purely on the LOCAL monotonic instant
    of the last advance (``GossipState.advanced_at`` semantics) — no
    cross-host clock comparison. Each live holder's share is ``1/n_live``,
    pushed into :meth:`QoSController.set_rate_share`, so the fleet-wide sum
    of enforced rates is exactly the global contract.

    Safety when a leaseholder dies: its entry stops advancing everywhere,
    so after ``ttl`` of silence survivors drop it from ``n_live`` and their
    shares GROW to reabsorb the freed budget. The failure window errs
    closed — between the death and the expiry the fleet enforces less than
    the global rate (the dead gateway's slice goes unused), never more;
    over-admission is impossible by construction. Thread-safe,
    clock-injectable, transport-free (the gossip layer drives it).
    """

    def __init__(self, ttl: float = 2.0, clock=time.monotonic):
        if ttl <= 0:
            raise ValueError(f"ttl must be > 0, got {ttl}")
        self.ttl = float(ttl)
        self._clock = clock
        self._lock = threading.Lock()
        # tenant -> holder -> local monotonic time of last observed advance
        self._leases: Dict[str, Dict[str, float]] = {}
        self.expired = 0

    def observe(self, tenant: str, holder: str) -> None:
        """A lease entry for (tenant, holder) advanced — published locally
        or accepted in a merge. Resets the holder's liveness window."""
        with self._lock:
            self._leases.setdefault(tenant, {})[holder] = self._clock()

    def release(self, tenant: str, holder: str) -> None:
        """Explicit release (clean gateway shutdown / lease tombstone)."""
        with self._lock:
            holders = self._leases.get(tenant)
            if holders is not None:
                holders.pop(holder, None)
                if not holders:
                    del self._leases[tenant]

    def holders(self, tenant: str, now: Optional[float] = None) -> list:
        """Live leaseholders, pruning any whose entry went ``ttl`` without
        advancing (the dead-gateway expiry)."""
        now = self._clock() if now is None else now
        with self._lock:
            holders = self._leases.get(tenant, {})
            dead = [h for h, at in holders.items() if now - at > self.ttl]
            for h in dead:
                del holders[h]
                self.expired += 1
                record_failure("qos.lease_expired", tenant=tenant,
                               holder=h)
            return sorted(holders)

    def share(self, tenant: str, holder: str,
              now: Optional[float] = None) -> float:
        """``holder``'s fraction of the tenant's global budget: 1/n over
        the live holders, counting ``holder`` itself even before its first
        observed advance (asking for a share IS holding a lease)."""
        live = set(self.holders(tenant, now))
        live.add(holder)
        return 1.0 / len(live)

    def tenants(self) -> list:
        with self._lock:
            return sorted(self._leases)

    def snapshot(self) -> dict:
        now = self._clock()
        with self._lock:
            return {"ttl_s": self.ttl, "expired": self.expired,
                    "tenants": {
                        t: {h: round(now - at, 3)
                            for h, at in holders.items()}
                        for t, holders in self._leases.items()}}


class WeightedFairQueue:
    """Bounded per-tenant lanes + virtual-time weighted-fair dequeue.

    Drop-in for the ``queue.Queue`` subset the serving pipeline uses; items
    must expose a ``tenant`` attribute (absent → ``DEFAULT_TENANT``).
    ``put_nowait`` raises :class:`queue.Full` when the item's OWN lane (or
    the global bound) is full — a flooding tenant backs up its lane and
    sheds at its own 503 while other lanes keep admitting.

    Dequeue picks the non-empty lane with the smallest virtual finish time
    and advances it by ``1/weight`` — tenants drain in proportion to their
    class weights under contention, strict FIFO within a lane. A lane going
    idle re-enters at the current virtual time (no credit hoarding: a burst
    after a quiet spell cannot monopolize formation)."""

    def __init__(self, maxsize: int = 1024,
                 qos: Optional[QoSController] = None):
        self.maxsize = int(maxsize)
        self.qos = qos
        self._lanes: Dict[str, deque] = {}
        self._vt: Dict[str, float] = {}
        self._now_vt = 0.0            # virtual time of the last dequeue
        self._size = 0
        self._cond = threading.Condition()

    def _lane_params(self, tenant: str):
        if self.qos is not None:
            qc = self.qos.qos_class(tenant)
            return qc.weight, min(qc.max_queue, self.maxsize)
        return 1.0, self.maxsize

    def put_nowait(self, item) -> None:
        tenant = getattr(item, "tenant", None) or DEFAULT_TENANT
        weight, cap = self._lane_params(tenant)
        with self._cond:
            lane = self._lanes.get(tenant)
            if lane is None:
                lane = self._lanes[tenant] = deque()
            if len(lane) >= cap or self._size >= self.maxsize:
                record_failure("qos.lane_full", tenant=tenant)
                raise queue.Full(f"tenant {tenant!r} lane full")
            if not lane:
                # idle lane re-enters at current virtual time
                self._vt[tenant] = max(self._vt.get(tenant, 0.0),
                                       self._now_vt)
            lane.append(item)
            self._size += 1
            self._cond.notify()

    def _pop_locked(self):
        best, best_vt = None, None
        for tenant, lane in self._lanes.items():
            if lane and (best_vt is None or self._vt[tenant] < best_vt):
                best, best_vt = tenant, self._vt[tenant]
        if best is None:
            raise queue.Empty
        item = self._lanes[best].popleft()
        weight, _ = self._lane_params(best)
        self._now_vt = best_vt
        self._vt[best] = best_vt + 1.0 / weight
        self._size -= 1
        return item

    def get_nowait(self):
        with self._cond:
            return self._pop_locked()

    def get(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._size == 0:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                self._cond.wait(remaining)
            return self._pop_locked()

    def qsize(self) -> int:
        with self._cond:
            return self._size

    def lane_depth(self, tenant: str) -> int:
        with self._cond:
            lane = self._lanes.get(tenant)
            return len(lane) if lane else 0

    def empty(self) -> bool:
        return self.qsize() == 0

    def snapshot(self) -> dict:
        with self._cond:
            return {t: len(lane) for t, lane in self._lanes.items() if lane}
