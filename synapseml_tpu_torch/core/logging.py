"""Structured logging + phase instrumentation.

The part of the JAX package's ``core/logging.py`` that the GBDT path needs:
``InstrumentationMeasures`` (named phase spans, the LightGBMPerformance
analog), ``StopWatch``, the ``SynapseMLLogging`` mixin that every
pipeline stage carries (construction and fit/transform records), and the
failure counters that checkpoint recovery increments (``record_failure``).
Secret scrubbing is not ported: no payload logged here carries credentials.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("synapseml_tpu_torch")

PROTOCOL_VERSION = "1.0.0"


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
        logger.log(level, json.dumps(payload, default=str))

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
    and emit a structured DEBUG record carrying ``detail``."""
    with _FAILURE_LOCK:
        _FAILURE_COUNTS[kind] = _FAILURE_COUNTS.get(kind, 0) + n
    if logger.isEnabledFor(logging.DEBUG):
        payload = {"event": "failure", "kind": kind, "n": n,
                   "protocolVersion": PROTOCOL_VERSION, **detail}
        logger.debug(json.dumps(payload, default=str))


def failure_counts() -> Dict[str, int]:
    """Snapshot of all failure counters (a copy)."""
    with _FAILURE_LOCK:
        return dict(_FAILURE_COUNTS)


def reset_failure_counts() -> None:
    """Zero the counters (test isolation)."""
    with _FAILURE_LOCK:
        _FAILURE_COUNTS.clear()
