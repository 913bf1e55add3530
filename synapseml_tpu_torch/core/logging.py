"""Structured logging + phase instrumentation.

The port of the JAX package's ``core/logging.py``: ``InstrumentationMeasures``
(named phase spans, the LightGBMPerformance analog), ``StopWatch``, the
``SynapseMLLogging`` mixin that every pipeline stage carries (construction
and fit/transform records), the failure counters that checkpoint recovery
and the HTTP client layer increment (``record_failure``), the secret
scrubbing every structured record passes through (``scrub_payload``,
``scrub_text``) and ``retry_with_timeout``. The JAX module's
``_maybe_jax_annotation`` (a profiler span around each verb) has no
counterpart: spans here are host wall time only.
"""

from __future__ import annotations

import contextlib
import json
import logging
import re
import threading
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("synapseml_tpu_torch")

PROTOCOL_VERSION = "1.0.0"

# --- secret scrubbing --------------------------------------------------------
# Every structured log line passes through scrub_payload + scrub_text before
# it reaches a handler, so a subscription key, SAS signature, bearer token or
# connection string in a param payload / error message can never land in logs.
# Analog (and superset) of the reference's SASScrubber
# (core/.../logging/common/Scrubber.scala: sig=... redaction only).

REDACTED = "####"

# key NAMES whose values are secret wherever they appear in a payload:
# either the whole key is a well-known secret word, or it contains a
# compound secret name (subscriptionKey, apiKey, accountKey, aadToken, ...)
_EXACT_SECRET_KEYS = re.compile(
    r"(?i)^(key|sig|sas|token|secret|password|pwd|auth|authorization|"
    r"bearer|credential|credentials)$")
_COMPOUND_SECRET_KEYS = re.compile(
    r"(?i)(subscription[_-]?key|api[_-]?key|account[_-]?key|shared[_-]?key|"
    r"access[_-]?token|aad[_-]?token|sas[_-]?token|refresh[_-]?token|"
    r"id[_-]?token|client[_-]?secret|connection[_-]?string|"
    r"ocp-apim-subscription-key)")

# value PATTERNS scrubbed out of any logged string (URLs in error messages,
# headers echoed by HTTP exceptions, ...)
_TEXT_PATTERNS = (
    # SAS / query-string signatures and credentials: sig=..., key=..., &c.
    (re.compile(r"(?i)\b(sig|signature|key|token|secret|password|pwd|"
                r"credential|sv|se|st|spr|sp)=([A-Za-z0-9%+/._~-]{8,}"
                r"(?:%3d|=){0,2})"), r"\1=" + REDACTED),
    # Authorization headers / bearer tokens
    (re.compile(r"(?i)\b(bearer|basic)[ :]+[A-Za-z0-9._+/=-]{8,}"),
     r"\1 " + REDACTED),
    # API-key-shaped literals (OpenAI-style)
    (re.compile(r"\bsk-[A-Za-z0-9]{16,}\b"), "sk-" + REDACTED),
    # explicit subscription-key headers serialized into text
    (re.compile(r"(?i)(ocp-apim-subscription-key[\"']?\s*[:=]\s*[\"']?)"
                r"[A-Za-z0-9-]{8,}"), r"\1" + REDACTED),
    # JWTs (three dot-separated base64url segments)
    (re.compile(r"\beyJ[A-Za-z0-9_-]{8,}\.[A-Za-z0-9_-]{8,}"
                r"\.[A-Za-z0-9_-]{8,}\b"), REDACTED),
)


def _is_secret_key(name: str) -> bool:
    return bool(_EXACT_SECRET_KEYS.match(name)
                or _COMPOUND_SECRET_KEYS.search(name))


def scrub_text(s: str) -> str:
    """Redact secret-shaped substrings from free text (error messages, URLs)."""
    for pat, repl in _TEXT_PATTERNS:
        s = pat.sub(repl, s)
    return s


def scrub_payload(obj: Any) -> Any:
    """Recursively redact secret-named fields and secret-shaped strings from
    a structured payload about to be logged."""
    if isinstance(obj, dict):
        return {k: (REDACTED if isinstance(k, str) and _is_secret_key(k)
                    else scrub_payload(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        vals = [scrub_payload(v) for v in obj]
        if hasattr(obj, "_make"):          # NamedTuple
            return type(obj)._make(vals)
        try:
            return type(obj)(vals)
        except TypeError:                  # exotic sequence subclass: the
            return vals                    # scrubbed content matters, not type
    if isinstance(obj, str):
        return scrub_text(obj)
    return obj


def _framework_version() -> str:
    from .. import __version__

    return __version__


class SynapseMLLogging:
    """Mixin: structured JSON log records for class creation and verbs."""

    def log_class(self) -> None:
        self._log_base("constructor")

    def _log_base(self, method: str, extra: Optional[Dict[str, Any]] = None,
                  level=logging.DEBUG) -> None:
        if not logger.isEnabledFor(level):
            return
        payload = {
            "uid": getattr(self, "uid", None),
            "className": type(self).__name__,
            "method": method,
            "libraryVersion": _framework_version(),
            "protocolVersion": PROTOCOL_VERSION,
        }
        if extra:
            payload.update(extra)
        # scrub twice: structured (secret-named fields) then textual (secret-
        # shaped values that survive json.dumps, e.g. URLs inside messages)
        logger.log(level, scrub_text(json.dumps(scrub_payload(payload),
                                                default=str)))

    @contextlib.contextmanager
    def log_verb(self, verb: str, **info):
        """Time a fit/transform body, logging duration or the error."""
        t0 = time.perf_counter()
        try:
            yield
        except Exception as e:
            self._log_base(verb, {"error": type(e).__name__,
                                  "message": str(e)[:500], **info},
                           level=logging.ERROR)
            raise
        ms = (time.perf_counter() - t0) * 1e3
        self._log_base(verb, {"durationMs": round(ms, 3), **info},
                       level=logging.INFO)


class StopWatch:
    """Reference: core/.../core/utils/StopWatch.scala — ad-hoc timing."""

    def __init__(self):
        self._t0 = None
        self.elapsed_s = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._t0 is not None:
            self.elapsed_s += time.perf_counter() - self._t0
            self._t0 = None
        return self.elapsed_s

    @contextlib.contextmanager
    def measure(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()


class InstrumentationMeasures:
    """Named phase spans and counters — the LightGBMPerformance analog::

        m = InstrumentationMeasures()
        with m.span("dataPreparation"): ...
        m.report()  # {"dataPreparation": seconds, ...}

    Spans are host wall time; a span around device work is only meaningful
    if the work inside ends in a synchronisation.
    """

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def report(self) -> Dict[str, float]:
        out: Dict[str, Any] = dict(self.spans)
        out.update({f"count:{k}": v for k, v in self.counters.items()})
        return out


# --- failure counters ---------------------------------------------------------

_FAILURE_COUNTS: Dict[str, int] = {}
_FAILURE_LOCK = threading.Lock()


def record_failure(kind: str, n: int = 1, **detail: Any) -> None:
    """Count one resilience event (dotted name, e.g. ``checkpoint.corrupt``)
    and emit a structured DEBUG record carrying ``detail`` (scrubbed)."""
    with _FAILURE_LOCK:
        _FAILURE_COUNTS[kind] = _FAILURE_COUNTS.get(kind, 0) + n
    if logger.isEnabledFor(logging.DEBUG):
        payload = {"event": "failure", "kind": kind, "n": n,
                   "protocolVersion": PROTOCOL_VERSION, **detail}
        logger.debug(scrub_text(json.dumps(scrub_payload(payload),
                                           default=str)))


def failure_counts() -> Dict[str, int]:
    """Snapshot of all failure counters (a copy)."""
    with _FAILURE_LOCK:
        return dict(_FAILURE_COUNTS)


def reset_failure_counts() -> None:
    """Zero the counters (test isolation)."""
    with _FAILURE_LOCK:
        _FAILURE_COUNTS.clear()


def retry_with_timeout(fn, retries: int = 3, initial_delay_s: float = 1.0,
                       timeout_s: Optional[float] = None):
    """Reference: core/.../core/utils/FaultToleranceUtils.scala:9-22 (retryWithTimeout)
    and NetworkManager.scala:195-218 (exponential backoff). Host-side only."""
    delay = initial_delay_s
    last_exc: Optional[Exception] = None
    deadline = time.monotonic() + timeout_s if timeout_s else None
    for attempt in range(retries):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — generic retry wrapper by design
            last_exc = e
            if deadline and time.monotonic() > deadline:
                break
            if attempt < retries - 1:
                time.sleep(delay)
                delay *= 2
    raise last_exc  # type: ignore[misc]
