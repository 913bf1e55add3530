"""HTTP-on-Table client layer.

Reference: io/http/HTTPTransformer.scala:93-147 (per-partition pooled async
clients, ``concurrency``/``timeout``/``concurrentTimeout``, handler function),
SimpleHTTPTransformer.scala (url + input/output parsers + errorCol +
mini-batching), HTTPSchema.scala (request/response structs), Parsers.scala,
RESTHelpers.scala (retry on 429/5xx with backoff). The reference rides Apache
HttpClient futures inside Spark partitions; here requests fan out over a
thread pool (IO-bound — threads are right even under the GIL) and land back as
columns.

The port's copy of the JAX package's ``io/http.py`` (it imports no JAX). One
change: the default transport is one opener built on first use and shared
by every thread (``_default_opener``), where ``urllib.request.urlopen``'s
first calls in many threads at once each build their own and load the TLS
certificates again.
"""

from __future__ import annotations

import json as _json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.logging import record_failure
from ..core.params import Param, HasInputCol, HasOutputCol
from ..core.pipeline import Transformer
from ..core.resilience import RetryBudget
from ..core.table import Table


@dataclass
class HTTPRequestData:
    """HTTPSchema.scala request struct analog."""
    url: str = ""
    method: str = "POST"
    headers: Dict[str, str] = field(default_factory=dict)
    entity: Optional[bytes] = None

    @staticmethod
    def from_json_body(url: str, body: Any,
                       headers: Optional[Dict[str, str]] = None
                       ) -> "HTTPRequestData":
        h = {"Content-Type": "application/json"}
        h.update(headers or {})
        return HTTPRequestData(url=url, method="POST", headers=h,
                               entity=_json.dumps(body).encode())


@dataclass
class HTTPResponseData:
    """HTTPSchema.scala response struct analog."""
    status_code: int = 0
    reason: str = ""
    headers: Dict[str, str] = field(default_factory=dict)
    entity: Optional[bytes] = None

    def json(self) -> Any:
        return _json.loads(self.entity.decode()) if self.entity else None

    @property
    def text(self) -> str:
        return self.entity.decode("utf-8", "replace") if self.entity else ""


_RETRY_CODES = (429, 500, 502, 503, 504)

_OPENER_LOCK = threading.Lock()
_OPENER = None


def _default_opener():
    """The process's default transport: ``urllib.request.build_opener()``,
    built once under a lock on first use (never at import)."""
    global _OPENER
    with _OPENER_LOCK:
        if _OPENER is None:
            _OPENER = urllib.request.build_opener()
        return _OPENER


def send_with_retries(req: HTTPRequestData, timeout: float = 60.0,
                      retries: int = 3, backoff: float = 0.5,
                      opener=None,
                      retry_budget: Optional[RetryBudget] = None
                      ) -> HTTPResponseData:
    """RESTHelpers.scala analog: retry 429/5xx with exponential backoff.

    ``opener`` substitutes the transport (anything with
    ``.open(request, timeout=)`` — e.g. a chaos injector from
    :mod:`~synapseml_tpu_torch.testing.chaos`). ``retry_budget`` caps AGGREGATE
    retry volume across callers sharing the bucket: each retry (not the
    first attempt) spends one token, and an empty bucket ends the retry
    loop early — the client-side brake on retry storms against an already
    overloaded service. None = unbounded retries (per-call knobs only)."""
    last: Optional[HTTPResponseData] = None
    for attempt in range(retries + 1):
        try:
            r = urllib.request.Request(req.url, data=req.entity,
                                       headers=req.headers,
                                       method=req.method)
            with (opener or _default_opener()).open(r, timeout=timeout) as resp:
                return HTTPResponseData(
                    status_code=resp.status, reason=getattr(resp, "reason", ""),
                    headers=dict(resp.headers), entity=resp.read())
        except urllib.error.HTTPError as e:
            last = HTTPResponseData(status_code=e.code, reason=str(e.reason),
                                    headers=dict(e.headers or {}),
                                    entity=e.read())
            if e.code not in _RETRY_CODES:
                return last
            record_failure("http.retryable_status", status=e.code)
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            last = HTTPResponseData(status_code=0, reason=str(e))
            record_failure("http.transport_error", error=type(e).__name__)
        if attempt < retries:
            if retry_budget is not None and not retry_budget.try_spend():
                record_failure("http.retry_budget_exhausted", url=req.url)
                break
            time.sleep(backoff * (2 ** attempt))
    return last or HTTPResponseData(status_code=0, reason="no attempts")


def dispatch_with_handler(req: HTTPRequestData, timeout: float, retries: int,
                          backoff: float, handler=None, opener=None,
                          retry_budget: Optional[RetryBudget] = None
                          ) -> HTTPResponseData:
    """Single dispatch point for handler-or-default sending (shared by
    HTTPTransformer and the services layer)."""
    send = lambda r: send_with_retries(r, timeout, retries, backoff,  # noqa: E731
                                       opener=opener,
                                       retry_budget=retry_budget)
    return handler(req, send) if handler is not None else send(req)


class HTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """Column of HTTPRequestData → column of HTTPResponseData
    (reference HTTPTransformer.scala:93-147)."""

    concurrency = Param("concurrency", "max simultaneous requests", int, 1)
    timeout = Param("timeout", "per-request timeout, seconds", float, 60.0)
    concurrentTimeout = Param("concurrentTimeout",
                              "overall timeout for a batch of concurrent "
                              "requests (None = wait forever)", float)
    handler = Param("handler", "function (HTTPRequestData, send) -> "
                    "HTTPResponseData overriding the default sender",
                    is_complex=True)
    maxRetries = Param("maxRetries", "retries for 429/5xx responses", int, 3)
    backoff = Param("backoff", "initial backoff, seconds", float, 0.5)
    opener = Param("opener", "transport override with .open(request, "
                   "timeout=) — e.g. a chaos injector", is_complex=True)
    retryBudget = Param("retryBudget", "shared RetryBudget token bucket "
                        "capping aggregate retry volume", is_complex=True)

    def setHandler(self, f: Callable) -> "HTTPTransformer":
        return self.set("handler", f)

    def _send_one(self, req: HTTPRequestData) -> HTTPResponseData:
        return dispatch_with_handler(req, self.getTimeout(),
                                     self.getMaxRetries(), self.getBackoff(),
                                     self.get("handler"),
                                     opener=self.get("opener"),
                                     retry_budget=self.get("retryBudget"))

    def _transform(self, df: Table) -> Table:
        import time as _time

        reqs: List[HTTPRequestData] = list(df[self.getInputCol()])
        workers = max(1, min(self.getConcurrency(),
                             df.concurrency_hint or self.getConcurrency()))
        if workers == 1:
            out = [self._send_one(r) for r in reqs]
        else:
            # concurrentTimeout is a SHARED wall-clock deadline for the whole
            # batch (reference awaitWithTimeout over the future batch)
            budget = self.get("concurrentTimeout")
            deadline = None if budget is None else _time.monotonic() + budget
            pool = ThreadPoolExecutor(max_workers=workers)
            try:
                futures = [pool.submit(self._send_one, r) for r in reqs]
                out = []
                for f in futures:
                    remaining = (None if deadline is None
                                 else max(deadline - _time.monotonic(), 0.0))
                    try:
                        out.append(f.result(timeout=remaining))
                    except FuturesTimeout:
                        # a done future raised the worker's own TimeoutError
                        # (same builtin type on py>=3.11) — propagate it; an
                        # undone future means the batch deadline expired
                        if f.done():
                            raise
                        pool.shutdown(wait=False, cancel_futures=True)
                        raise TimeoutError(
                            "HTTPTransformer: batch exceeded "
                            f"concurrentTimeout={budget}s") from None
            finally:
                pool.shutdown(wait=False, cancel_futures=True)
        col = np.empty(len(out), dtype=object)
        col[:] = out
        return df.with_column(self.getOutputCol(), col)


# --- parsers (Parsers.scala analogs) ---------------------------------------

class JSONInputParser(Transformer, HasInputCol, HasOutputCol):
    """Row value → JSON POST HTTPRequestData."""
    url = Param("url", "target url", str)
    headers = Param("headers", "extra headers", is_complex=True)

    def _transform(self, df: Table) -> Table:
        vals = df[self.getInputCol()]
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            body = v.tolist() if isinstance(v, np.ndarray) else \
                (v.item() if isinstance(v, np.generic) else v)
            out[i] = HTTPRequestData.from_json_body(
                self.getUrl(), body, self.get("headers"))
        return df.with_column(self.getOutputCol(), out)


class CustomInputParser(Transformer, HasInputCol, HasOutputCol):
    """User function value → HTTPRequestData."""
    udf = Param("udf", "value -> HTTPRequestData", is_complex=True)

    def setUDF(self, f: Callable) -> "CustomInputParser":
        return self.set("udf", f)

    def _transform(self, df: Table) -> Table:
        f = self.get("udf")
        vals = df[self.getInputCol()]
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            out[i] = f(v)
        return df.with_column(self.getOutputCol(), out)


class JSONOutputParser(Transformer, HasInputCol, HasOutputCol):
    """HTTPResponseData → parsed JSON (optionally projected by dataType keys)."""
    postProcessor = Param("postProcessor", "optional json -> value function",
                          is_complex=True)

    def _transform(self, df: Table) -> Table:
        post = self.get("postProcessor")
        resps = df[self.getInputCol()]
        out = np.empty(len(resps), dtype=object)
        for i, r in enumerate(resps):
            val = r.json() if r is not None and r.entity else None
            out[i] = post(val) if post is not None and val is not None else val
        return df.with_column(self.getOutputCol(), out)


class StringOutputParser(Transformer, HasInputCol, HasOutputCol):
    def _transform(self, df: Table) -> Table:
        resps = df[self.getInputCol()]
        out = np.array([r.text if r is not None else "" for r in resps],
                       dtype=object)
        return df.with_column(self.getOutputCol(), out)


class CustomOutputParser(Transformer, HasInputCol, HasOutputCol):
    udf = Param("udf", "HTTPResponseData -> value", is_complex=True)

    def setUDF(self, f: Callable) -> "CustomOutputParser":
        return self.set("udf", f)

    def _transform(self, df: Table) -> Table:
        f = self.get("udf")
        resps = df[self.getInputCol()]
        out = np.empty(len(resps), dtype=object)
        for i, r in enumerate(resps):
            out[i] = f(r)
        return df.with_column(self.getOutputCol(), out)


class SimpleHTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """Input parse → HTTP → output parse, with error column
    (reference SimpleHTTPTransformer.scala:65-180)."""

    url = Param("url", "service url", str)
    inputParser = Param("inputParser", "value -> HTTPRequestData transformer",
                        is_complex=True)
    outputParser = Param("outputParser", "HTTPResponseData -> value "
                         "transformer", is_complex=True)
    errorCol = Param("errorCol", "column to hold http errors", str)
    concurrency = Param("concurrency", "max simultaneous requests", int, 1)
    timeout = Param("timeout", "per-request timeout, seconds", float, 60.0)
    handler = Param("handler", "custom send handler", is_complex=True)
    opener = Param("opener", "transport override with .open(request, "
                   "timeout=) — e.g. a chaos injector", is_complex=True)
    retryBudget = Param("retryBudget", "shared RetryBudget token bucket "
                        "capping aggregate retry volume", is_complex=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if not self.isSet("errorCol"):
            self.set("errorCol", self.uid + "_errors")

    def _transform(self, df: Table) -> Table:
        in_parser = self.get("inputParser") or JSONInputParser()
        in_parser = in_parser.copy()  # never mutate the caller's parser
        in_parser.set("inputCol", self.getInputCol())
        in_parser.set("outputCol", "__request")
        if in_parser.hasParam("url") and self.isSet("url"):
            in_parser.set("url", self.getUrl())

        http = HTTPTransformer(inputCol="__request", outputCol="__response",
                               concurrency=self.getConcurrency(),
                               timeout=self.getTimeout())
        if self.get("handler") is not None:
            http.setHandler(self.get("handler"))
        for p in ("opener", "retryBudget"):
            if self.get(p) is not None:
                http.set(p, self.get(p))

        out_parser = (self.get("outputParser") or JSONOutputParser()).copy()
        out_parser.set("inputCol", "__response")
        out_parser.set("outputCol", self.getOutputCol())

        cur = out_parser.transform(http.transform(in_parser.transform(df)))
        resps = cur["__response"]
        errors = np.empty(len(resps), dtype=object)
        for i, r in enumerate(resps):
            errors[i] = (None if r is not None and 200 <= r.status_code < 300
                         else {"statusCode": getattr(r, "status_code", 0),
                               "reason": getattr(r, "reason", "no response")})
        cur = cur.with_column(self.getErrorCol(), errors)
        del cur["__request"], cur["__response"]
        return cur
