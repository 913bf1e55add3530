"""Resilience primitives of the serving layer.

A copy of the JAX package's ``core/resilience.py`` (it imports no JAX):
thread-safe, clock-injectable building blocks that the port's
``io/serving.py`` and ``core/qos.py`` use.

* :class:`Deadline` — an absolute per-request time budget that propagates
  from the client header through admission and batch formation to the
  handler's budget, so overload degrades to fast 504s instead of open-ended
  hangs.
* :class:`RetryBudget` — a token-bucket cap on the aggregate retry volume a
  process may emit: under a correlated backend failure the first failures
  retry and the rest fail fast.
* :class:`CircuitBreaker` — the three-state (closed → open → half-open)
  breaker with escalating re-open cooldowns; ``core/qos.py`` quarantines a
  tenant with one.
* :class:`Membership` — a heartbeat-driven liveness table for dynamic
  worker pools (kept for the distributed serving layer, which is not
  ported yet).

Every clock is an argument (default ``time.monotonic``), so tests drive the
port and the JAX package with the same fake times.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

# Remaining-budget header, in integer milliseconds. Relative (not an absolute
# wall-clock instant) so it survives clock skew between client, gateway and
# worker; each hop re-anchors it against its own monotonic clock.
DEADLINE_HEADER = "X-Deadline-Ms"


class Deadline:
    """Absolute deadline on the local monotonic clock.

    ``Deadline.after(0.25)`` expires 250 ms from now; ``remaining()`` is the
    handler budget left, clamped at 0. ``None`` budgets are allowed at the
    call sites (no deadline), so helpers accept ``Optional[Deadline]``.
    """

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = at

    @classmethod
    def after(cls, seconds: float, clock=time.monotonic) -> "Deadline":
        return cls(clock() + seconds)

    @classmethod
    def from_header_ms(cls, value, cap_s: float,
                       clock=time.monotonic) -> "Deadline":
        """Deadline from an ``X-Deadline-Ms`` header value, capped by the
        server's own limit (a client must not pin server resources longer
        than the server would allow on its own)."""
        try:
            ms = float(value)
        except (TypeError, ValueError):
            return cls.after(cap_s, clock)
        return cls(clock() + min(max(ms, 0.0) / 1e3, cap_s))

    def remaining(self, clock=time.monotonic) -> float:
        return max(self.at - clock(), 0.0)

    def expired(self, clock=time.monotonic) -> bool:
        return clock() >= self.at

    def header_value(self, clock=time.monotonic) -> str:
        """Serialized remaining budget for propagation to the next hop."""
        return str(int(self.remaining(clock) * 1e3))


class RetryBudget:
    """Token bucket shared across callers: each retry spends one token;
    tokens refill at ``rate_per_sec`` up to ``burst``.

    ``try_spend()`` never blocks — an empty bucket means "do not retry",
    which is the whole point: under a correlated failure the process's total
    retry volume is capped at ``burst + rate_per_sec * t`` regardless of how
    many requests are in flight. One instance can back every
    ``send_with_retries`` / services-layer transformer in the process
    (:data:`default_retry_budget`), or a subsystem can carry its own.
    """

    def __init__(self, rate_per_sec: float = 5.0, burst: float = 20.0,
                 clock=time.monotonic):
        if burst <= 0 or rate_per_sec < 0:
            raise ValueError("RetryBudget needs burst > 0 and rate >= 0")
        self.rate = float(rate_per_sec)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = threading.Lock()
        self.spent = 0          # retries granted
        self.denied = 0         # retries refused (budget exhausted)

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_spend(self, cost: float = 1.0) -> bool:
        with self._lock:
            self._refill()
            if self._tokens >= cost:
                self._tokens -= cost
                self.spent += 1
                return True
            self.denied += 1
            return False

    def available(self) -> float:
        with self._lock:
            self._refill()
            return self._tokens


#: Process-wide default budget: callers that opt into budgeted retries without
#: wiring an instance share this one, so independent transformers cannot
#: multiply each other's retry storms.
default_retry_budget = RetryBudget()


class CircuitBreaker:
    """Three-state breaker: CLOSED (normal) → OPEN after
    ``failure_threshold`` consecutive failures (all traffic refused for a
    cooldown) → HALF_OPEN (exactly one probe allowed) → CLOSED on probe
    success, or back to OPEN with an escalated cooldown on probe failure
    (cooldown * 2^reopens, capped at ``max_backoff_mult``).

    Passive: it learns only from ``record_success``/``record_failure`` calls
    made by the traffic that flows anyway — no health-check pinger thread.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3, cooldown: float = 1.0,
                 max_backoff_mult: int = 8, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self.max_backoff_mult = max_backoff_mult
        self._clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.open_until = 0.0
        self._reopens = 0           # consecutive OPEN episodes (escalation)
        self._probe_inflight = False

    def available(self, now: Optional[float] = None) -> bool:
        """Would a request be admitted right now? Non-mutating — selection
        loops may call it on every candidate without consuming the
        half-open probe slot."""
        now = self._clock() if now is None else now
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                return now >= self.open_until
            return not self._probe_inflight            # HALF_OPEN

    def try_acquire(self, now: Optional[float] = None) -> bool:
        """Admit one request (mutating): an elapsed OPEN transitions to
        HALF_OPEN and this caller becomes the single probe. Callers MUST
        follow with record_success/record_failure to release the probe."""
        now = self._clock() if now is None else now
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN and now >= self.open_until:
                self.state = self.HALF_OPEN
                self._probe_inflight = True
                return True
            if self.state == self.HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.state = self.CLOSED
            self.consecutive_failures = 0
            self._reopens = 0
            self._probe_inflight = False

    def record_failure(self) -> None:
        now = self._clock()
        with self._lock:
            self.consecutive_failures += 1
            if self.state == self.HALF_OPEN:
                self._probe_inflight = False
                self._reopens += 1
                self._open(now)
            elif (self.state == self.CLOSED
                    and self.consecutive_failures >= self.failure_threshold):
                self._open(now)
            elif self.state == self.OPEN:
                # failure from the all-open fallback path: extend the window
                self._open(now)

    def _open(self, now: float) -> None:
        mult = min(2 ** self._reopens, self.max_backoff_mult)
        self.state = self.OPEN
        self.open_until = now + self.cooldown * mult

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state,
                    "consecutive_failures": self.consecutive_failures,
                    "open_until": self.open_until}


class Membership:
    """Heartbeat liveness table: ``beat(member)`` marks a member alive now,
    ``expired()`` names members whose last beat is older than ``timeout``
    (callers evict them and free whatever routing state they held), and a
    later ``beat`` from an evicted member is a clean rejoin (``beat``
    returns True when the member is new or returning).

    Members registered with ``beat(member, static=True)`` are *static*:
    they never expire, which is the compatibility mode for worker pools
    configured as a fixed URL list with no heartbeat reporter — liveness
    for those stays the breaker's job alone.

    Thread-safe and clock-injectable (tests drive it with a fake clock).
    ``info`` carried by a beat (queue depth, warmed buckets, model version)
    is stored verbatim for routing/observability reads via ``snapshot()``.
    """

    def __init__(self, timeout: float = 3.0, clock=time.monotonic):
        if timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        self.timeout = timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._last: dict = {}        # member -> last beat (monotonic)
        self._info: dict = {}        # member -> latest info dict
        self._static: set = set()
        self.joins = 0               # first-time registrations
        self.rejoins = 0             # beats from previously-evicted members
        self.evictions = 0
        self._evicted: set = set()

    def beat(self, member, static: bool = False, **info):
        """Record a heartbeat; returns ``"join"`` when this beat admits a
        first-time member, ``"rejoin"`` when it readmits an evicted one,
        and ``None`` for an ordinary keep-alive beat (truthy iff the beat
        (re)admitted the member).

        A non-static beat for a member registered static UPGRADES it to
        dynamic: the member proved it has a live heartbeat reporter, so
        heartbeat silence becomes meaningful and it is now evictable."""
        with self._lock:
            status = None
            if member not in self._last:
                if member in self._evicted:
                    self._evicted.discard(member)
                    self.rejoins += 1
                    status = "rejoin"
                else:
                    self.joins += 1
                    status = "join"
            self._last[member] = self._clock()
            if info or member not in self._info:
                self._info[member] = dict(info)
            if static:
                self._static.add(member)
            else:
                self._static.discard(member)
            return status

    def info(self, member) -> dict:
        with self._lock:
            return dict(self._info.get(member, {}))

    def alive(self, member, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        with self._lock:
            last = self._last.get(member)
            if last is None:
                return False
            return member in self._static or now - last <= self.timeout

    def expired(self, now: Optional[float] = None) -> list:
        """Members overdue for eviction (non-static, last beat older than
        ``timeout``). Non-mutating; callers follow with :meth:`evict`."""
        now = self._clock() if now is None else now
        with self._lock:
            return [m for m, last in self._last.items()
                    if m not in self._static and now - last > self.timeout]

    def evict(self, member) -> bool:
        """Drop a member (idempotent); a later beat counts as a rejoin."""
        with self._lock:
            if member not in self._last:
                return False
            del self._last[member]
            self._info.pop(member, None)
            self._static.discard(member)
            self._evicted.add(member)
            self.evictions += 1
            return True

    def evict_if_expired(self, member, now: Optional[float] = None) -> bool:
        """Evict ``member`` only if it is STILL overdue, re-checked under
        the lock. :meth:`expired` + :meth:`evict` is a two-step read/act
        with a race in the gap: a member that heartbeats between the read
        and the unconditional evict — a rejoin in the very tick it would
        die — gets evicted anyway, dropping routing state the beat just
        refreshed. Lazy sweeps must use this instead; the unconditional
        :meth:`evict` stays for voluntary leaves (deregister), where the
        member ASKED to go regardless of beat freshness."""
        now = self._clock() if now is None else now
        with self._lock:
            last = self._last.get(member)
            if last is None or member in self._static \
                    or now - last <= self.timeout:
                return False
            del self._last[member]
            self._info.pop(member, None)
            self._evicted.add(member)
            self.evictions += 1
            return True

    def evict_stale(self, now: Optional[float] = None) -> list:
        """Evict every expired member in one sweep and return those evicted.

        :meth:`expired` + :meth:`evict` only run when something consults the
        table (the routing/health path) — an IDLE gateway holds dead workers
        indefinitely. Supervisor loops call this on their own cadence so
        membership decays even with zero traffic; each eviction is counted
        under ``fabric.evicted_idle``. Staleness is re-checked per member
        under the lock (:meth:`evict_if_expired`), so a rejoin beat racing
        the sweep keeps its membership."""
        stale = self.expired(now)
        evicted = [m for m in stale if self.evict_if_expired(m, now)]
        if evicted:
            from .logging import record_failure
            record_failure("fabric.evicted_idle", n=len(evicted),
                           members=[str(m) for m in evicted])
        return evicted

    def members(self) -> list:
        with self._lock:
            return list(self._last)

    def snapshot(self, now: Optional[float] = None) -> dict:
        now = self._clock() if now is None else now
        with self._lock:
            return {
                "members": {
                    str(m): {"age_s": round(now - last, 3),
                             "static": m in self._static,
                             **self._info.get(m, {})}
                    for m, last in self._last.items()},
                "joins": self.joins, "rejoins": self.rejoins,
                "evictions": self.evictions, "timeout_s": self.timeout}
