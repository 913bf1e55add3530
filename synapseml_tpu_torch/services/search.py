"""Azure AI Search writer + Bing search transformer.

Reference: cognitive/.../services/search/AzureSearch.scala (~754 LoC,
AzureSearchWriter indexes DataFrames in batches with mergeOrUpload actions)
and services/bing/BingImageSearch.scala.

The port's copy of the JAX package's ``services/search.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import json as _json
from typing import List, Optional

import numpy as np

from ..core.params import Param
from ..core.table import Table
from ..io.http import HTTPRequestData, send_with_retries
from ..io.powerbi import json_records
from .base import CognitiveServiceBase


class AzureSearchWriter:
    """Batch-index a Table into an Azure AI Search index
    (reference AzureSearchWriter.stream/write)."""

    def __init__(self, service_name: str, index_name: str, key: str,
                 action_col: str = "@search.action",
                 default_action: str = "mergeOrUpload",
                 batch_size: int = 100, api_version: str = "2023-11-01",
                 url: Optional[str] = None, retries: int = 3):
        self.url = (url or f"https://{service_name}.search.windows.net") \
            + f"/indexes/{index_name}/docs/index?api-version={api_version}"
        self.key = key
        self.action_col = action_col
        self.default_action = default_action
        self.batch_size = batch_size
        self.retries = retries

    def write(self, df: Table) -> int:
        rows = json_records(df)
        written = 0
        for start in range(0, len(rows), self.batch_size):
            chunk = rows[start:start + self.batch_size]
            for r in chunk:
                r.setdefault(self.action_col, self.default_action)
            req = HTTPRequestData.from_json_body(
                self.url, {"value": chunk}, {"api-key": self.key})
            resp = send_with_retries(req, retries=self.retries)
            if not 200 <= resp.status_code < 300:
                raise RuntimeError(f"index batch failed at {start}: "
                                   f"{resp.status_code} {resp.reason}")
            written += len(chunk)
        return written


class BingImageSearch(CognitiveServiceBase):
    """Image search (reference BingImageSearch.scala); emits the raw value
    list — ``downloadFromUrls`` is a helper on the result."""

    qCol = Param("qCol", "column of queries", str, "q")
    count = Param("count", "results per query", int, 10)
    offset = Param("offset", "result offset", int, 0)
    imageType = Param("imageType", "photo|clipart|...", str)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if not self.isSet("url"):
            self.set("url",
                     "https://api.bing.microsoft.com/v7.0/images/search")

    def _prepare_method(self):
        return "GET"

    def _prepare_url(self, df, i):
        from urllib.parse import quote

        q = quote(str(df[self.getQCol()][i]))
        u = (f"{self.get('url')}?q={q}&count={self.getCount()}"
             f"&offset={self.getOffset()}")
        it = self.get("imageType")
        return u + (f"&imageType={it}" if it else "")

    def _prepare_body(self, df, i):
        return b""  # GET

    def _parse_response(self, parsed, df, i):
        try:
            return [v["contentUrl"] for v in parsed["value"]]
        except (KeyError, TypeError):
            return parsed

    @staticmethod
    def downloadFromUrls(urls: List[str], concurrency: int = 4,
                         timeout: float = 30.0) -> List[Optional[bytes]]:
        from concurrent.futures import ThreadPoolExecutor

        def get(u):
            r = send_with_retries(
                HTTPRequestData(url=u, method="GET", headers={}),
                timeout=timeout, retries=1)
            return r.entity if 200 <= r.status_code < 300 else None

        with ThreadPoolExecutor(max_workers=concurrency) as pool:
            return list(pool.map(get, urls))


class AddDocuments(CognitiveServiceBase):
    """Push rows into an Azure Search index (reference search/AzureSearch.scala
    AddDocuments transformer — POST indexes/{index}/docs/index with a batch of
    @search.action documents). The standalone writer counterpart is
    AzureSearchWriter above."""

    serviceName = Param("serviceName", "search service name", str)
    indexName = Param("indexName", "target index", str)
    actionCol = Param("actionCol", "per-row @search.action column", str,
                      "@search.action")
    batchSize = Param("batchSize", "rows per indexing batch", int, 100)
    apiVersion = Param("apiVersion", "API version", str, "2023-11-01")

    def _prepare_url(self, df, i):
        if self.get("url"):
            return self.get("url")
        return (f"https://{self.get('serviceName')}.search.windows.net/"
                f"indexes/{self.get('indexName')}/docs/index"
                f"?api-version={self.getApiVersion()}")

    def _prepare_headers(self, df, i):
        h = super()._prepare_headers(df, i)
        key = self._resolve("subscriptionKey", df, i)
        if key:
            h["api-key"] = str(key)
        return h

    def _doc(self, df, i):
        action_col = self.get("actionCol")
        skip = {self.get("outputCol"), self.get("errorCol"), action_col}
        doc = {c: _to_plain(df[c][i]) for c in df.columns if c not in skip}
        doc["@search.action"] = (df[action_col][i]
                                 if action_col in df.columns else "upload")
        return doc

    def _prepare_body(self, df, i):
        # batching handled in _transform; single-row fallback
        return {"value": [self._doc(df, i)]}

    def _transform(self, df):
        import json as _json

        import numpy as np

        from ..io.http import HTTPRequestData

        n = df.num_rows
        bs = max(1, self.getBatchSize())
        out = np.empty(n, dtype=object)
        err = np.empty(n, dtype=object)
        for s in range(0, n, bs):
            rows = range(s, min(s + bs, n))
            body = {"value": [self._doc(df, i) for i in rows]}
            req = HTTPRequestData(
                url=self._prepare_url(df, s), method="POST",
                headers=self._prepare_headers(df, s),
                entity=_json.dumps(body).encode())
            r = self._send_one(req)
            if r is not None and 200 <= r.status_code < 300:
                try:
                    results = r.json().get("value", [])
                except Exception:
                    results = []
                for j, i in enumerate(rows):
                    out[i] = results[j] if j < len(results) else None
                    err[i] = None
            else:
                for i in rows:
                    out[i] = None
                    err[i] = {"statusCode": getattr(r, "status_code", None),
                              "reason": getattr(r, "reason", "send failed")}
        res = df.with_column(self.get("outputCol"), out)
        return res.with_column(self.get("errorCol"), err)


def _to_plain(v):
    import base64

    import numpy as np

    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (bytes, bytearray)):
        # Azure Search binary fields are base64 (Edm.Binary)
        return base64.b64encode(bytes(v)).decode()
    return v
