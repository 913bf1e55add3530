"""AI-service transformer base machinery.

Reference: cognitive/.../services/CognitiveServiceBase.scala:32-518 —
``ServiceParam``s settable as a scalar or a per-row column
(setX / setXCol), ``HasCognitiveServiceInput`` (row → HTTP request with
subscription-key / AAD auth headers), ``HasInternalJsonOutputParser``
(response → typed output column), async pooled execution with retries. These
are host-side transformers (SURVEY.md §2.8): no device work, so the machinery
reuses the io/http layer; the value here is API-surface parity.

The port's copy of the JAX package's ``services/base.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import json as _json
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.table import Table
from ..io.http import HTTPRequestData, HTTPResponseData


class HasServiceParams(Transformer):
    """Scalar-or-column params (reference HasServiceParams:32-129).

    Subclasses declare service params via ``_service_params`` (name -> doc);
    the metaclass-free approach: ``setX(value)`` sets the scalar,
    ``setXCol(colname)`` binds the value to a column, ``_resolve(name, df, i)``
    reads whichever is set.
    """

    serviceParamCols = Param("serviceParamCols", "map: service param -> "
                             "bound column name", is_complex=True)

    def set_scalar(self, name: str, value: Any):
        return self.set(name, value)

    def set_vector(self, name: str, col: str):
        cols = dict(self.get("serviceParamCols") or {})
        cols[name] = col
        return self.set("serviceParamCols", cols)

    def _resolve(self, name: str, df: Optional[Table] = None,
                 i: Optional[int] = None, default: Any = None) -> Any:
        cols = self.get("serviceParamCols") or {}
        if name in cols:
            if df is None or i is None:
                return default
            v = df[cols[name]][i]
            return v.item() if isinstance(v, np.generic) else v
        v = self.get(name) if self.hasParam(name) else None
        return default if v is None else v

    def __getattr__(self, item):
        # setXCol sugar for every declared param (reference setVectorParam)
        if item.startswith("set") and item.endswith("Col") and len(item) > 6:
            stem = item[3:-3]
            # try lowered-first-letter ("maxTokens") then verbatim ("AADToken")
            for pname in (stem[0].lower() + stem[1:], stem):
                if pname in type(self)._params:
                    def _set(col: str, _p=pname):
                        self.set_vector(_p, col)
                        return self

                    return _set
        raise AttributeError(f"{type(self).__name__} has no attribute {item!r}")


class CognitiveServiceBase(HasServiceParams):
    """Row → HTTP request → JSON → output column
    (reference CognitiveServicesBase:447-518 + HasCognitiveServiceInput:258-359).
    Subclasses override ``_prepare_url``/``_prepare_body``/``_parse_response``.
    """

    subscriptionKey = Param("subscriptionKey", "service subscription key", str)
    aadToken = Param("AADToken", "AAD auth token", str)
    url = Param("url", "service base url", str)
    outputCol = Param("outputCol", "output column", str)
    errorCol = Param("errorCol", "per-row error column", str)
    concurrency = Param("concurrency", "max concurrent requests", int, 1)
    timeout = Param("timeout", "per-request timeout seconds", float, 60.0)
    maxRetries = Param("maxRetries", "retries on 429/5xx", int, 3)
    backoff = Param("backoff", "initial backoff seconds", float, 0.5)
    handler = Param("handler", "(HTTPRequestData, send) -> HTTPResponseData",
                    is_complex=True)
    opener = Param("opener", "transport override with .open(request, "
                   "timeout=) — e.g. a chaos injector", is_complex=True)
    retryBudget = Param("retryBudget", "shared RetryBudget token bucket "
                        "capping aggregate retry volume", is_complex=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if not self.isSet("outputCol"):
            self.set("outputCol", self.uid + "_output")
        if not self.isSet("errorCol"):
            self.set("errorCol", self.uid + "_error")

    # --- overridables ---------------------------------------------------
    def _prepare_url(self, df: Table, i: int) -> str:
        u = self.get("url")
        if not u:
            raise ValueError(f"{type(self).__name__}: url is not set "
                             "(setUrl / setLocation)")
        return u

    def _prepare_body(self, df: Table, i: int) -> Optional[Any]:
        raise NotImplementedError

    def _prepare_method(self) -> str:
        return "POST"

    def _prepare_headers(self, df: Table, i: int) -> Dict[str, str]:
        h = {"Content-Type": "application/json"}
        key = self._resolve("subscriptionKey", df, i)
        if key:
            h["Ocp-Apim-Subscription-Key"] = str(key)
        tok = self._resolve("AADToken", df, i)
        if tok:
            h["Authorization"] = f"Bearer {tok}"
        return h

    def _parse_response(self, parsed: Any, df: Table, i: int) -> Any:
        return parsed

    # --- execution ------------------------------------------------------
    def _send_one(self, req: Optional[HTTPRequestData]) -> Optional[HTTPResponseData]:
        if req is None:
            return None
        from ..io.http import dispatch_with_handler

        return dispatch_with_handler(req, self.getTimeout(),
                                     self.getMaxRetries(), self.getBackoff(),
                                     self.get("handler"),
                                     opener=self.get("opener"),
                                     retry_budget=self.get("retryBudget"))

    def _transform(self, df: Table) -> Table:
        n = df.num_rows
        reqs = []
        for i in range(n):
            body = self._prepare_body(df, i)
            if body is None:
                reqs.append(None)
                continue
            entity = (body if isinstance(body, bytes)
                      else _json.dumps(body).encode())
            reqs.append(HTTPRequestData(
                url=self._prepare_url(df, i), method=self._prepare_method(),
                headers=self._prepare_headers(df, i), entity=entity))

        workers = max(1, self.getConcurrency())
        if workers == 1:
            resps = [self._send_one(r) for r in reqs]
        else:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                resps = list(pool.map(self._send_one, reqs))

        out = np.empty(n, dtype=object)
        err = np.empty(n, dtype=object)
        for i, r in enumerate(resps):
            if r is None:
                out[i] = None
                err[i] = None
            elif 200 <= r.status_code < 300:
                try:
                    parsed = r.json()
                except Exception:
                    parsed = r.text
                out[i] = self._parse_response(parsed, df, i)
                err[i] = None
            else:
                out[i] = None
                err[i] = {"statusCode": r.status_code, "reason": r.reason,
                          "body": r.text[:2000]}
        res = df.with_column(self.get("outputCol"), out)
        return res.with_column(self.get("errorCol"), err)


class HasAsyncReply(CognitiveServiceBase):
    """Shared long-running-operation flow (reference HasAsyncReply:360-416):
    submit → Location/Operation-Location → poll until a terminal status →
    synthetic 504 when polls are exhausted. Subclasses set ``_status_of`` if
    the terminal status lives somewhere other than top-level "status"."""

    pollInterval = Param("pollInterval", "seconds between polls", float, 1.0)
    maxPollRetries = Param("maxPollRetries", "max polls", int, 60)

    _done_states = ("succeeded", "failed", "READY", "FAILED")

    @staticmethod
    def _status_of(info: dict) -> str:
        return str(info.get("status", ""))

    def _send_one(self, req):
        import time as _t

        first = super()._send_one(req)
        if first is None or first.status_code not in (200, 201, 202):
            return first
        # Operation-Location always marks an LRO; a plain Location only does
        # on 201/202 (a 200 with Location is a complete response — return it)
        loc = None
        for k, v in (first.headers or {}).items():
            if k.lower() == "operation-location":
                loc = v
                break
            if k.lower() == "location" and first.status_code in (201, 202):
                loc = v
        if not loc:
            return first
        headers = {k: v for k, v in req.headers.items()
                   if k.lower() != "content-type"}
        poll_req = HTTPRequestData(url=loc, method="GET", headers=headers)
        poll = None
        for _ in range(self.getMaxPollRetries()):
            poll = super()._send_one(poll_req)
            if poll is None:
                break
            try:
                info = poll.json() if poll.entity else {}
            except Exception:
                info = {}
            if self._status_of(info or {}) in self._done_states:
                return poll
            _t.sleep(self.getPollInterval())
        # poll exhausted/errored: report a timeout, NOT the 202 submit ack
        return HTTPResponseData(
            status_code=504,
            reason=f"operation at {loc} did not complete within "
                   f"{self.getMaxPollRetries()} polls",
            entity=(poll.entity if poll is not None else None))


class HasSetLocation(CognitiveServiceBase):
    """setLocation builds the azure domain url (reference HasSetLocation:418-432)."""

    urlPath: str = ""  # subclass constant

    def setLocation(self, location: str):
        # US-gov regions live under .us (reference DomainHelper:433-445)
        tld = "us" if "usgov" in location or "ussec" in location else "com"
        return self.set(
            "url", f"https://{location}.api.cognitive.microsoft.{tld}/"
            + self.urlPath.lstrip("/"))

    def setCustomServiceName(self, name: str):
        return self.set("url", f"https://{name}.cognitiveservices.azure.com/"
                        + self.urlPath.lstrip("/"))
