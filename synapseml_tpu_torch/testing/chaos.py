"""Deterministic, seedable fault injection for the fabric, the online
loop and AutoML (the port's copy of the JAX package's ``testing/chaos.py`` pieces that
the serving fabric's and the online loop's scenarios drive).

Each injector installs its hook on the PORT's modules
(``io.distributed_serving._HEARTBEAT_HOOK`` / ``_GOSSIP_HOOK``,
``io.serving._SWAP_HOOK``, ``core.checkpoint._PREEMPT_HOOK``) or wraps a
port object in place, so the same scenarios run against the port's
gateway, workers and learner loop:

* transport and worker faults — :class:`ChaosSchedule`,
  :class:`FlakyHTTPServer`, :func:`kill_worker`,
  :class:`chaos_heartbeat_partition`;
* HTTP clients and serving handlers — :class:`ChaosHTTP` (the ``opener``
  that ``io.http.send_with_retries``, ``HTTPTransformer`` and every
  service transformer take), :func:`canned_json_responder` and
  :func:`chaotic_handler`;
* the federated control plane — :func:`kill_gateway`,
  :class:`chaos_control_plane_partition`;
* model swaps and tenants — :class:`ChaosSwap`,
  :class:`chaos_tenant_flood`;
* the online loop — :class:`ChaosPreemption`, :func:`torn_write`,
  :func:`bit_flip`, :class:`chaos_reward_stream`;
* AutoML's search and gang — :class:`chaos_candidate` (on
  ``automl.scheduler._CHAOS_HOOK``), :func:`kill_rank`.

Everything is driven by either an explicit ``script`` (a list of outcomes
consumed one per call — fully deterministic) or seeded rates via
``random.Random(seed)`` (deterministic per seed). No decision reads the
wall clock.
"""

from __future__ import annotations

import io as _io
import random
import socket
import threading
import time
import urllib.error
import urllib.request
import json as _json
from typing import Callable, List, Optional, Sequence, Tuple, Union


# an injected transport fault; ConnectionError so existing except-clauses
# (URLError/OSError handlers) treat it like the real thing
class FaultInjected(ConnectionError):
    pass


# outcome vocabulary (script entries):
#   "ok"            — pass through / succeed
#   int (e.g. 503)  — HTTP error status
#   "reset"         — connection reset (transport error)
#   "timeout"       — injected timeout (transport error)
#   ("slow", s)     — sleep s seconds, then succeed
Outcome = Union[str, int, Tuple[str, float]]


class ChaosSchedule:
    """Deterministic outcome source: a finite ``script`` consumed first
    (then ``after`` forever), else seeded rates. Thread-safe; ``calls`` and
    ``outcomes`` record every decision for assertions."""

    def __init__(self, seed: int = 0, script: Optional[Sequence[Outcome]] = None,
                 after: Outcome = "ok", error_rate: float = 0.0,
                 error_codes: Sequence[int] = (503,), reset_rate: float = 0.0,
                 timeout_rate: float = 0.0, latency_s: float = 0.0):
        self.rng = random.Random(seed)
        self.script: List[Outcome] = list(script or [])
        self.after = after
        self.error_rate = error_rate
        self.error_codes = tuple(error_codes)
        self.reset_rate = reset_rate
        self.timeout_rate = timeout_rate
        self.latency_s = latency_s
        self.calls = 0
        self.outcomes: List[Outcome] = []
        self._lock = threading.Lock()

    def next_outcome(self) -> Outcome:
        with self._lock:
            self.calls += 1
            if self.script:
                out = self.script.pop(0)
            elif self.error_rate or self.reset_rate or self.timeout_rate:
                r = self.rng.random()
                if r < self.reset_rate:
                    out = "reset"
                elif r < self.reset_rate + self.timeout_rate:
                    out = "timeout"
                elif r < (self.reset_rate + self.timeout_rate
                          + self.error_rate):
                    out = self.rng.choice(self.error_codes)
                else:
                    out = "ok"
            else:
                out = self.after
            self.outcomes.append(out)
            return out


class _CannedResponse:
    """Minimal urlopen-response stand-in (context manager + status/reason/
    headers/read) for canned 2xx replies."""

    def __init__(self, status: int = 200, body: bytes = b"{}",
                 headers: Optional[dict] = None):
        self.status = status
        self.reason = "OK"
        self.headers = dict(headers or {"Content-Type": "application/json"})
        self._body = body

    def read(self) -> bytes:
        return self._body

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ChaosHTTP:
    """Fault-injecting HTTP opener.

    Use as ``send_with_retries(req, opener=chaos)`` or set as the ``opener``
    param on ``HTTPTransformer`` / any ``CognitiveServiceBase`` subclass. On
    "ok" it forwards to ``inner`` (default: real ``urllib.request.urlopen``)
    unless a ``responder`` is given, in which case the canned
    ``responder(request) -> (status, body_bytes)`` result is returned without
    touching the network — fully hermetic chaos tests.
    """

    def __init__(self, schedule: Optional[ChaosSchedule] = None,
                 responder: Optional[Callable] = None, inner=None, **sched_kw):
        self.schedule = schedule or ChaosSchedule(**sched_kw)
        self.responder = responder
        self.inner = inner

    def open(self, request, timeout: Optional[float] = None):
        out = self.schedule.next_outcome()
        if self.schedule.latency_s:
            time.sleep(self.schedule.latency_s)
        if isinstance(out, tuple) and out[0] == "slow":
            time.sleep(out[1])
            out = "ok"
        if out == "reset":
            raise FaultInjected("chaos: connection reset by peer")
        if out == "timeout":
            raise TimeoutError("chaos: injected timeout")
        if isinstance(out, int) and out >= 400:
            raise urllib.error.HTTPError(
                getattr(request, "full_url", "chaos://"), out,
                f"chaos injected {out}", {},
                _io.BytesIO(b'{"error": "chaos"}'))
        if self.responder is not None:
            status, body = self.responder(request)
            return _CannedResponse(status, body)
        if self.inner is not None:
            return self.inner(request, timeout=timeout)
        from ..io.http import _default_opener

        return _default_opener().open(request, timeout=timeout)

    # services-layer escape hatch: a ``handler`` (HTTPRequestData, send) that
    # routes the default send through this opener — for call sites that take
    # a handler but not an opener
    def as_handler(self):
        from ..io.http import send_with_retries

        def handler(req, send):
            return send_with_retries(req, opener=self)

        return handler


def chaotic_handler(handler: Callable, schedule: Optional[ChaosSchedule] = None,
                    poison: Optional[Callable] = None,
                    slow_s: float = 0.0, **sched_kw) -> Callable:
    """Wrap a serving handler (``Table -> Table``) with injected faults.

    Per call: consume one schedule outcome — "reset"/"timeout"/int all raise
    (a handler exception is a handler exception; the server's isolation and
    500-mapping take it from there); ``("slow", s)`` and ``slow_s`` sleep
    before delegating. ``poison(value) -> bool`` marks individual request
    payloads: any poisoned row in the batch raises, so a server WITHOUT
    per-row isolation 500s the whole batch and one WITH isolation fails only
    the poisoned row — the distinction test_chaos_serving asserts.

    The wrapped handler forwards the server's optional ``budget=`` kwarg when
    the inner handler accepts it.
    """
    sched = schedule or ChaosSchedule(**sched_kw)
    import inspect

    try:
        inner_takes_budget = "budget" in inspect.signature(handler).parameters
    except (TypeError, ValueError):
        inner_takes_budget = False

    def wrapped(df, budget: Optional[float] = None):
        out = sched.next_outcome()
        if slow_s:
            time.sleep(slow_s)
        if isinstance(out, tuple) and out[0] == "slow":
            time.sleep(out[1])
            out = "ok"
        if out != "ok":
            raise FaultInjected(f"chaos handler fault: {out}")
        if poison is not None and "value" in df:
            for v in df["value"]:
                if poison(v):
                    raise FaultInjected("chaos: poisoned row in batch")
        if inner_takes_budget:
            return handler(df, budget=budget)
        return handler(df)

    return wrapped


class FlakyHTTPServer:
    """A real TCP backend whose per-REQUEST behavior follows a script —
    the worker-side fault source for gateway/breaker tests.

    Outcomes per request: int status → respond (keep-alive) with a canned
    JSON body; "reset" → close the socket mid-request (client sees
    ECONNRESET/EOF); "ignore" → read the request and never respond (client
    times out); "ok" → 200. After the script: "ok" forever. ``requests``
    counts requests actually read off the wire — the probe-count signal the
    breaker tests assert on.
    """

    def __init__(self, script: Optional[Sequence[Outcome]] = None,
                 body: bytes = b'{"chaos": true}'):
        self.script: List[Outcome] = list(script or [])
        self.body = body
        self.requests = 0
        self._lock = threading.Lock()
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(32)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _next(self) -> Outcome:
        with self._lock:
            self.requests += 1
            return self.script.pop(0) if self.script else "ok"

    def _read_request(self, conn: socket.socket) -> bool:
        """Read one HTTP request (headers + content-length body); False on
        EOF/garbage (connection done)."""
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = conn.recv(4096)
            if not chunk:
                return False
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        length = 0
        for line in head.split(b"\r\n")[1:]:
            k, _, v = line.partition(b":")
            if k.strip().lower() == b"content-length":
                length = int(v.strip() or 0)
        while len(rest) < length:
            chunk = conn.recv(4096)
            if not chunk:
                return False
            rest += chunk
        return True

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(30)
            while not self._stop.is_set():
                if not self._read_request(conn):
                    return
                out = self._next()
                if out == "reset":
                    # RST instead of FIN: SO_LINGER(0) aborts the connection
                    conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                    b"\x01\x00\x00\x00\x00\x00\x00\x00")
                    return
                if out == "ignore":
                    while not self._stop.is_set():   # hold the socket open,
                        time.sleep(0.05)             # never respond
                    return
                if isinstance(out, tuple) and out[0] == "slow":
                    time.sleep(out[1])
                    out = "ok"
                status = out if isinstance(out, int) else 200
                payload = self.body
                head = (f"HTTP/1.1 {status} X\r\n"
                        f"Content-Type: application/json\r\n"
                        f"Content-Length: {len(payload)}\r\n\r\n")
                conn.sendall(head.encode() + payload)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def start(self) -> "FlakyHTTPServer":
        def accept_loop():
            while not self._stop.is_set():
                try:
                    conn, _ = self._sock.accept()
                except OSError:
                    return
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True).start()

        self._accept_thread = threading.Thread(target=accept_loop, daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "FlakyHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()



# ---------------------------------------------------------------------------
# Training-path chaos: preemption kills and checkpoint corruptors
# ---------------------------------------------------------------------------

def canned_json_responder(obj) -> Callable:
    """``responder`` helper for :class:`ChaosHTTP`: always 200 with ``obj``
    as the JSON body."""
    body = _json.dumps(obj).encode()

    def responder(_request):
        return 200, body

    return responder


class ChaosPreemption:
    """Context manager killing a training loop at its
    :func:`~synapseml_tpu_torch.core.checkpoint.preemption_point` boundaries —
    the deterministic stand-in for a preempted host (SIGTERM mid-step).

    Kill triggers, combinable:

    * ``at`` — mapping of phase name (or phase prefix ending in ``.``) to a
      set of step indices; the FIRST matching call raises
      :class:`~synapseml_tpu_torch.core.checkpoint.PreemptionError`. Each entry
      fires once (a resumed run re-visits the same step and must survive).
    * ``kill_rate`` — seeded probability of dying at any boundary.
    * ``max_kills`` — stop injecting after this many kills (default 1).

    ``calls`` records every boundary visited, ``kills`` every injected
    death. PreemptionError derives from BaseException, so no library
    except-Exception handler can swallow the kill. Nesting is not supported
    (single global hook)."""

    def __init__(self, at: Optional[dict] = None, kill_rate: float = 0.0,
                 seed: int = 0, max_kills: int = 1):
        self.at = {k: set(v) for k, v in (at or {}).items()}
        self.kill_rate = kill_rate
        self.rng = random.Random(seed)
        self.max_kills = max_kills
        self.calls: List[Tuple[str, int]] = []
        self.kills: List[Tuple[str, int]] = []
        self._lock = threading.Lock()

    def _hook(self, phase: str, step: int) -> None:
        from ..core.checkpoint import PreemptionError
        from ..core.logging import record_failure

        with self._lock:
            self.calls.append((phase, step))
            if len(self.kills) >= self.max_kills:
                return
            die = False
            for pat, steps in self.at.items():
                if (phase == pat or (pat.endswith(".")
                                     and phase.startswith(pat))) \
                        and step in steps:
                    steps.discard(step)   # one-shot: resume survives this step
                    die = True
                    break
            if not die and self.kill_rate and \
                    self.rng.random() < self.kill_rate:
                die = True
            if not die:
                return
            self.kills.append((phase, step))
        record_failure("chaos.preemption", phase=phase, step=int(step))
        raise PreemptionError(f"chaos: preempted at {phase}[{step}]")

    def __enter__(self) -> "ChaosPreemption":
        from ..core import checkpoint as _ck

        if _ck._PREEMPT_HOOK is not None:
            raise RuntimeError("ChaosPreemption does not nest")
        _ck._PREEMPT_HOOK = self._hook
        return self

    def __exit__(self, *exc) -> None:
        from ..core import checkpoint as _ck

        _ck._PREEMPT_HOOK = None


def _newest_checkpoint_artifacts(ckpt_dir: str) -> List[str]:
    """Artifact files (not the manifest) of the newest checkpoint in a
    CheckpointStore directory."""
    import os

    from ..core.checkpoint import MANIFEST_SUFFIX

    manifests = sorted(f for f in os.listdir(ckpt_dir)
                       if f.endswith(MANIFEST_SUFFIX))
    if not manifests:
        raise FileNotFoundError(f"no checkpoint manifests in {ckpt_dir}")
    base = manifests[-1][: -len(MANIFEST_SUFFIX)]
    return [os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)
            if f.startswith(base + ".") and not f.endswith(MANIFEST_SUFFIX)]


def torn_write(ckpt_dir: str, keep_bytes: int = 7) -> str:
    """Corrupt the NEWEST checkpoint like an interrupted write: truncate its
    artifact to ``keep_bytes`` bytes, leaving the manifest in place. The
    store must detect the size/digest mismatch and fall back. Returns the
    truncated file's path."""
    import os

    path = _newest_checkpoint_artifacts(ckpt_dir)[0]
    size = os.path.getsize(path)
    keep = min(max(keep_bytes, 0), max(size - 1, 0))   # always lose >=1 byte
    with open(path, "rb") as f:
        head = f.read(keep)
    with open(path, "wb") as f:
        f.write(head)
    return path


def bit_flip(ckpt_dir: str, offset: Optional[int] = None, bit: int = 3) -> str:
    """Corrupt the NEWEST checkpoint like storage bit rot: flip one bit in
    its artifact (middle byte by default). Size is unchanged, so only the
    CRC/SHA digests can catch it. Returns the flipped file's path."""
    path = _newest_checkpoint_artifacts(ckpt_dir)[0]
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if not data:
        raise ValueError(f"cannot bit-flip empty file {path}")
    i = len(data) // 2 if offset is None else offset
    data[i] ^= 1 << (bit & 7)
    with open(path, "wb") as f:
        f.write(bytes(data))
    return path


# ---------------------------------------------------------------------------
# Fabric chaos: worker and gateway kills, heartbeat and control-plane
# partitions, killed swaps, noisy tenants
# ---------------------------------------------------------------------------

def kill_worker(worker) -> None:
    """Hard-kill a ServingServer like a process crash: no drain, no
    deregister farewell — the listener closes immediately, in-flight
    connections break, queued requests die with the process. The gateway
    must discover this the hard way (transport failures tripping the
    breaker, then heartbeat silence evicting the link) — which is exactly
    what this primitive exists to exercise. Idempotent."""
    worker._stop.set()
    worker._draining.set()
    if worker._httpd is not None:
        try:
            worker._httpd.shutdown()
            worker._httpd.server_close()
        except OSError:
            pass


class chaos_heartbeat_partition:
    """Context manager partitioning worker heartbeats away from the gateway
    while leaving the DATA path untouched — the nastiest membership case
    (the gateway evicts a worker that is still perfectly able to serve).

    Installs the ``io.distributed_serving._HEARTBEAT_HOOK`` consulted by
    every :class:`~synapseml_tpu_torch.io.distributed_serving.WorkerAgent` beat:
    a partitioned beat is dropped on the floor (never sent). Deterministic
    control, combinable:

    * ``worker_ids`` — only these agents are affected (default: all).
    * ``partition()`` / ``heal()`` — explicit toggle (starts partitioned).
    * ``schedule`` — a :class:`ChaosSchedule` consulted per beat while
      partitioned is on; any non-"ok" outcome drops the beat.

    ``dropped`` records every dropped (worker_id) for assertions. Nesting
    is not supported (single global hook)."""

    def __init__(self, worker_ids: Optional[Sequence[str]] = None,
                 schedule: Optional[ChaosSchedule] = None,
                 partitioned: bool = True):
        self.worker_ids = set(worker_ids) if worker_ids is not None else None
        self.schedule = schedule
        self._partitioned = partitioned
        self.dropped: List[str] = []
        self._lock = threading.Lock()

    def partition(self) -> None:
        with self._lock:
            self._partitioned = True

    def heal(self) -> None:
        with self._lock:
            self._partitioned = False

    def _hook(self, worker_id: str) -> bool:
        """True = let the beat through; False = drop it."""
        with self._lock:
            if not self._partitioned:
                return True
            if self.worker_ids is not None and \
                    worker_id not in self.worker_ids:
                return True
            if self.schedule is not None and \
                    self.schedule.next_outcome() == "ok":
                return True
            self.dropped.append(worker_id)
            return False

    def __enter__(self) -> "chaos_heartbeat_partition":
        from ..io import distributed_serving as _ds

        if _ds._HEARTBEAT_HOOK is not None:
            raise RuntimeError("chaos_heartbeat_partition does not nest")
        _ds._HEARTBEAT_HOOK = self._hook
        return self

    def __exit__(self, *exc) -> None:
        from ..io import distributed_serving as _ds

        _ds._HEARTBEAT_HOOK = None


def kill_gateway(gateway) -> None:
    """Hard-kill a ServingGateway like a process crash: the public
    listener closes immediately (in-flight forwards break back to their
    clients as connection errors), the gossip replicator stops (its
    liveness entry stops advancing, so peers declare it dead after
    ``peer_timeout`` and rehash its ring arcs; its leases expire after
    ``lease_ttl``), and ``gateway.alive()`` flips False — a
    :class:`~synapseml_tpu_torch.io.distributed_serving.PromotionBroadcast` it
    was coordinating dies mid-round with
    :class:`~synapseml_tpu_torch.io.distributed_serving.CoordinatorDied`,
    leaving the recovery to a surviving peer. No farewell of any kind is
    sent: peers and workers must discover the death the hard way, which
    is exactly what this primitive exists to exercise. Idempotent."""
    gateway._killed.set()
    gateway._repl_stop.set()
    if gateway._httpd is not None:
        try:
            gateway._httpd.shutdown()
            gateway._httpd.server_close()
        except OSError:
            pass


class chaos_control_plane_partition:
    """Context manager partitioning the gateways' REPLICATED control plane
    (gossip anti-entropy exchanges) while leaving data paths and worker
    heartbeats intact — the split-brain case: every gateway keeps serving
    from its last converged state while membership/lease/promotion updates
    stop flowing between the partitioned sides.

    Installs the ``io.distributed_serving._GOSSIP_HOOK`` consulted by every
    replicator before each exchange with ``(source_gateway_id, peer_url)``;
    a partitioned exchange is dropped (never dialed). Deterministic
    control, combinable:

    * ``gateway_ids`` — only exchanges ORIGINATED by these gateways are
      affected (default: all). One-sided partitions fall out of listing a
      single side.
    * ``partition()`` / ``heal()`` — explicit toggle (starts partitioned);
      after heal the next exchanges re-converge the fabric (anti-entropy
      is idempotent, so nothing is lost — replication lag just drains).
    * ``schedule`` — a :class:`ChaosSchedule` consulted per exchange while
      partitioned; any non-"ok" outcome drops it (flaky control plane).

    ``dropped`` records every dropped (gateway_id, peer_url) pair for
    assertions. Nesting is not supported (single global hook)."""

    def __init__(self, gateway_ids: Optional[Sequence[str]] = None,
                 schedule: Optional[ChaosSchedule] = None,
                 partitioned: bool = True):
        self.gateway_ids = set(gateway_ids) \
            if gateway_ids is not None else None
        self.schedule = schedule
        self._partitioned = partitioned
        self.dropped: List[Tuple[str, str]] = []
        self._lock = threading.Lock()

    def partition(self) -> None:
        with self._lock:
            self._partitioned = True

    def heal(self) -> None:
        with self._lock:
            self._partitioned = False

    def _hook(self, gateway_id: str, peer_url: str) -> bool:
        """True = let the exchange through; False = drop it."""
        with self._lock:
            if not self._partitioned:
                return True
            if self.gateway_ids is not None and \
                    gateway_id not in self.gateway_ids:
                return True
            if self.schedule is not None and \
                    self.schedule.next_outcome() == "ok":
                return True
            self.dropped.append((gateway_id, peer_url))
            return False

    def __enter__(self) -> "chaos_control_plane_partition":
        from ..io import distributed_serving as _ds

        if _ds._GOSSIP_HOOK is not None:
            raise RuntimeError(
                "chaos_control_plane_partition does not nest")
        _ds._GOSSIP_HOOK = self._hook
        return self

    def __exit__(self, *exc) -> None:
        from ..io import distributed_serving as _ds

        _ds._GOSSIP_HOOK = None


class ChaosSwap:
    """Context manager killing a model hot-swap at a chosen stage — the
    deterministic stand-in for "the process handling the swap hit a bug /
    bad checkpoint / OOM mid-transition".

    Installs ``io.serving._SWAP_HOOK``, called by
    :class:`~synapseml_tpu_torch.io.serving.ModelRegistry` at every swap state
    transition (``load`` → ``build`` → ``warmup`` → ``flip`` → ``done``).
    ``at`` names the stage(s) to die at; each entry fires once
    (``max_kills`` total, default 1), raising :class:`FaultInjected` —
    which the registry maps to a rolled-back
    :class:`~synapseml_tpu_torch.io.serving.SwapError`. Any pre-flip kill must
    leave the OLD version serving uninterrupted; that is the property
    the fabric scenarios assert. ``stages`` records every transition
    visited. Nesting is not supported (single global hook)."""

    def __init__(self, at: Union[str, Sequence[str]] = "warmup",
                 max_kills: int = 1):
        self.at = {at} if isinstance(at, str) else set(at)
        self.max_kills = max_kills
        self.stages: List[Tuple[str, str]] = []
        self.kills: List[Tuple[str, str]] = []
        self._lock = threading.Lock()

    def _hook(self, stage: str, version: str) -> None:
        with self._lock:
            self.stages.append((stage, version))
            if stage not in self.at or len(self.kills) >= self.max_kills:
                return
            self.kills.append((stage, version))
        raise FaultInjected(f"chaos: killed swap to {version!r} at {stage}")

    def __enter__(self) -> "ChaosSwap":
        from ..io import serving as _sv

        if _sv._SWAP_HOOK is not None:
            raise RuntimeError("ChaosSwap does not nest")
        _sv._SWAP_HOOK = self._hook
        return self

    def __exit__(self, *exc) -> None:
        from ..io import serving as _sv

        _sv._SWAP_HOOK = None


class chaos_tenant_flood:
    """Noisy-neighbor generator: ONE tenant floods a serving endpoint with
    a seeded burst while (optionally) its own handler is sabotaged — slow
    batches and/or non-finite outputs. The multitenant scenarios use it to
    assert the isolation invariant: the abusive tenant sheds at its OWN
    429/503 boundary while every other tenant's p99 and availability hold.

    Two independent knobs, combinable:

    * **Flood** — :meth:`run` fires ``n_requests`` POSTs at ``url`` with
      the ``X-Tenant: <tenant>`` header from ``threads`` concurrent
      workers, bodies drawn from ``random.Random(seed)`` (deterministic
      per seed). Every ``(status, latency_s)`` lands in ``results``;
      :meth:`status_counts` tallies them for assertions.
    * **Sabotage** — entering the context manager swaps the victim
      tenant's handler on ``server`` for a wrapper that sleeps ``slow_s``
      per batch and/or (``nan=True``) replies with non-finite floats,
      exercising the serving NaN guard (per-tenant 500 → quarantine
      breaker). ``__exit__`` restores the original handler.

    No global hook is involved — the wrap is per-(server, tenant) — so
    unlike the other injectors this one nests freely (one instance per
    tenant under attack).
    """

    def __init__(self, url: str, tenant: str, n_requests: int = 100,
                 threads: int = 4, seed: int = 0, timeout: float = 5.0,
                 server=None, slow_s: float = 0.0, nan: bool = False):
        self.url = url
        self.tenant = tenant
        self.n_requests = n_requests
        self.threads = threads
        self.timeout = timeout
        self.rng = random.Random(seed)
        self.server = server
        self.slow_s = slow_s
        self.nan = nan
        self.results: List[Tuple[int, float]] = []
        self._lock = threading.Lock()
        self._orig_handler = None
        self._installed = False

    # -- sabotage: wrap the victim tenant's handler in place --
    def _sabotaged(self, inner: Callable) -> Callable:
        import numpy as _np

        from ..core.table import Table as _Table

        slow_s, emit_nan = self.slow_s, self.nan

        def wrapped(df, budget=None):
            if slow_s:
                time.sleep(slow_s)
            if emit_nan:
                # non-finite replies: json.dumps emits literal NaN, which
                # the server's qos guard converts to a per-tenant 500
                return _Table({
                    "id": df["id"],
                    "reply": _np.full(df.num_rows, _np.nan)})
            return inner(df)

        return wrapped

    def __enter__(self) -> "chaos_tenant_flood":
        if self.server is not None and (self.slow_s or self.nan):
            handlers = getattr(self.server, "tenant_handlers", None)
            if handlers and self.tenant in handlers:
                self._orig_handler = handlers[self.tenant]
                handlers[self.tenant] = self._sabotaged(self._orig_handler)
            else:
                self._orig_handler = self.server.handler
                self.server.handler = self._sabotaged(self._orig_handler)
            self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            handlers = getattr(self.server, "tenant_handlers", None)
            if handlers and self.tenant in handlers:
                handlers[self.tenant] = self._orig_handler
            else:
                self.server.handler = self._orig_handler
            self._installed = False

    # -- flood --
    def _one(self, body: bytes) -> None:
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json",
                     "X-Tenant": self.tenant})
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                resp.read()
                status = resp.status
        except urllib.error.HTTPError as e:
            e.read()
            status = e.code
        except (OSError, urllib.error.URLError):
            status = 599      # transport failure (reset/timeout)
        with self._lock:
            self.results.append((status, time.monotonic() - t0))

    def run(self) -> List[Tuple[int, float]]:
        """Fire the burst; blocks until every request has an outcome."""
        with self._lock:
            bodies = [_json.dumps(
                {"value": self.rng.random()}).encode()
                for _ in range(self.n_requests)]
        work = list(bodies)
        wlock = threading.Lock()

        def worker():
            while True:
                with wlock:
                    if not work:
                        return
                    body = work.pop()
                self._one(body)

        ts = [threading.Thread(target=worker, daemon=True)
              for _ in range(self.threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        with self._lock:
            return list(self.results)

    def status_counts(self) -> dict:
        """``{status: count}`` over everything :meth:`run` has sent."""
        with self._lock:
            out: dict = {}
            for status, _ in self.results:
                out[status] = out.get(status, 0) + 1
            return out


# ---------------------------------------------------------------------------
# Online-learning chaos: corrupted feedback/reward streams
# (the online scenarios drive it on the CPU; the asserted property is the
# online invariant — the served policy version always passed the
# counterfactual gate, no matter what the reward stream does)


class chaos_reward_stream:
    """Seeded corruptor for ``(context, action, probability, reward)``
    feedback event streams — the failure model a real reward pipeline has
    (``online/feedback.FeedbackLog`` must absorb all of it):

    * **delayed** — an event is held back and released after up to
      ``max_delay`` later events (out-of-order arrival; join lag).
    * **duplicated** — the same event (same dedup key) is emitted twice
      (at-least-once delivery from the log shipper).
    * **NaN reward** — the reward field arrives non-finite (a poisoned
      join or a divide-by-zero upstream).
    * **adversarial reward** — the reward arrives wildly out of the
      declared ``[reward_min, reward_max]`` range (reward hacking / metric
      pipeline bugs), as ``adversarial_reward``.

    Wraps any iterable of events whose items expose a ``reward`` field via
    ``dataclasses.replace`` (e.g. ``online.feedback.FeedbackEvent``).
    Deterministic per ``seed``: the same stream + seed replays the same
    corruption sequence. ``delayed``/``duplicated``/``nans``/
    ``adversarial`` count every injected corruption for assertions; no
    event is ever silently dropped — every input event is emitted at least
    once (corrupted or not), so conservation asserts stay simple.
    """

    def __init__(self, events, seed: int = 0, delay_rate: float = 0.0,
                 max_delay: int = 4, dup_rate: float = 0.0,
                 nan_rate: float = 0.0, adversarial_rate: float = 0.0,
                 adversarial_reward: float = 1e9):
        self.events = events
        self.rng = random.Random(seed)
        self.delay_rate = delay_rate
        self.max_delay = max(int(max_delay), 1)
        self.dup_rate = dup_rate
        self.nan_rate = nan_rate
        self.adversarial_rate = adversarial_rate
        self.adversarial_reward = adversarial_reward
        self.delayed = 0
        self.duplicated = 0
        self.nans = 0
        self.adversarial = 0

    def _corrupt_reward(self, ev):
        import dataclasses

        r = self.rng.random()
        if r < self.nan_rate:
            self.nans += 1
            return dataclasses.replace(ev, reward=float("nan"))
        if r < self.nan_rate + self.adversarial_rate:
            self.adversarial += 1
            return dataclasses.replace(ev, reward=self.adversarial_reward)
        return ev

    def __iter__(self):
        #: (release_after_index, event) — held-back events re-entering later
        pending: List[Tuple[int, object]] = []
        i = 0
        for ev in self.events:
            i += 1
            ready = [e for due, e in pending if due <= i]
            pending = [(due, e) for due, e in pending if due > i]
            for e in ready:
                yield e
            ev = self._corrupt_reward(ev)
            if self.rng.random() < self.dup_rate:
                self.duplicated += 1
                yield ev            # the duplicate leads; the original
                yield ev            # follows immediately (same dedup key)
                continue
            if self.rng.random() < self.delay_rate:
                self.delayed += 1
                pending.append((i + self.rng.randint(1, self.max_delay), ev))
                continue
            yield ev
        # stream over: flush every still-held event, original order
        for _, e in sorted(pending, key=lambda p: p[0]):
            yield e


# ---------------------------------------------------------------------------
# AutoML chaos: seeded per-candidate faults, and hard-killed gang ranks
# ---------------------------------------------------------------------------

class chaos_candidate:
    """Seeded per-candidate fault injector for the elastic AutoML scheduler.

    Installs the port's ``automl.scheduler._CHAOS_HOOK`` (single global
    slot, same pattern as :class:`ChaosPreemption`); the scheduler invokes
    the hook as ``hook(key, rung, attempt)`` inside the budgeted task thread,
    *before* the candidate's fold fits. The action is a pure function of
    ``(seed, key, rung, attempt)`` — sha256-hashed to a uniform draw against
    the cumulative ``p_crash/p_hang/p_nan/p_slow`` thresholds — so a chaotic
    search interrupted and resumed replays the exact same faults as an
    uninterrupted one.

    * ``crash`` raises :class:`FaultInjected` (the scheduler retries up to
      its attempt budget; the *attempt* coordinate re-rolls the dice, so a
      retry may survive);
    * ``hang`` blocks on an internal event for up to ``hang_s`` seconds —
      the scheduler's budget reaper is expected to score the candidate NaN
      long before that backstop;
    * ``nan`` poisons the metric (the scheduler skips the fit and scores
      the chunk NaN);
    * ``slow`` sleeps ``slow_s`` then proceeds normally.
    """

    def __init__(self, seed: int = 0, p_crash: float = 0.0,
                 p_hang: float = 0.0, p_nan: float = 0.0,
                 p_slow: float = 0.0, hang_s: float = 30.0,
                 slow_s: float = 0.05):
        self.seed = int(seed)
        self.p_crash, self.p_hang = float(p_crash), float(p_hang)
        self.p_nan, self.p_slow = float(p_nan), float(p_slow)
        self.hang_s, self.slow_s = float(hang_s), float(slow_s)
        self.injected: List[Tuple[str, str, int, int]] = []
        self._lock = threading.Lock()
        self._release = threading.Event()

    def action(self, key: str, rung: int, attempt: int) -> Optional[str]:
        """The (pure, replayable) fault decision for one task attempt."""
        import hashlib as _hashlib

        blob = f"{self.seed}:{key}:{rung}:{attempt}".encode("utf-8")
        u = int.from_bytes(_hashlib.sha256(blob).digest()[:8], "big") / 2**64
        for name, p in (("crash", self.p_crash), ("hang", self.p_hang),
                        ("nan", self.p_nan), ("slow", self.p_slow)):
            if u < p:
                return name
            u -= p
        return None

    def release(self) -> None:
        """Unstick every hung candidate thread."""
        self._release.set()

    def _hook(self, key: str, rung: int, attempt: int) -> Optional[str]:
        act = self.action(key, rung, attempt)
        if act is None:
            return None
        with self._lock:
            self.injected.append((act, key, int(rung), int(attempt)))
        if act == "crash":
            raise FaultInjected(
                f"chaos_candidate crash: {key[:8]} rung {rung} "
                f"attempt {attempt}")
        if act == "hang":
            self._release.wait(self.hang_s)
            return None
        if act == "slow":
            time.sleep(self.slow_s)
            return None
        return "nan"

    def __enter__(self) -> "chaos_candidate":
        from ..automl import scheduler as _s

        if _s._CHAOS_HOOK is not None:
            raise RuntimeError("chaos_candidate does not nest")
        _s._CHAOS_HOOK = self._hook
        return self

    def __exit__(self, *exc) -> None:
        from ..automl import scheduler as _s

        _s._CHAOS_HOOK = None
        self._release.set()   # never leave an abandoned thread blocked

    def __del__(self):
        self._release.set()


def kill_rank(target, rank: Optional[int] = None) -> int:
    """Hard-kill one training process (SIGKILL: no atexit, no farewell —
    its heartbeat file simply stops updating), the process-level analog of
    :func:`kill_worker`. ``target`` is a ``subprocess.Popen``-like handle
    (``rank`` ignored) or a ``parallel.elastic.TrainingSupervisor`` whose
    ``procs[rank]`` is the victim. The corpse is reaped (``wait``) so a
    supervisor's next ``observe()`` sees a clean exit code, not a zombie.
    Returns the pid killed."""
    proc = target
    if hasattr(target, "procs"):
        ranks = sorted(target.procs)
        proc = target.procs[rank if rank is not None else ranks[0]]
    if proc is None:
        raise ValueError(f"rank {rank} has no live process to kill")
    proc.kill()
    proc.wait()
    return proc.pid
