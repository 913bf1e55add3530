"""Anomaly Detector transformers.

Reference: cognitive/.../services/anomaly/AnomalyDetection.scala (~1279 LoC:
DetectLastAnomaly, DetectAnomalies, SimpleDetectAnomalies, and the
multivariate train/poll lifecycle in SimpleDetectMultivariateAnomaly). The
univariate detectors POST a ``{series, granularity}`` body; the multivariate
estimator's long-running train/poll flow is represented by
``DetectMultivariateAnomaly`` with explicit submit/poll helpers.

The port's copy of the JAX package's ``services/anomaly.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ..core.params import Param
from ..core.pipeline import Estimator
from ..core.table import Table
from ..io.http import HTTPRequestData
from .base import HasAsyncReply, HasSetLocation


class _AnomalyBase(HasSetLocation):
    seriesCol = Param("seriesCol", "column of [{timestamp, value}] series",
                      str, "series")
    granularity = Param("granularity", "yearly|monthly|weekly|daily|hourly|"
                        "minutely|secondly", str, "monthly")
    maxAnomalyRatio = Param("maxAnomalyRatio", "max anomaly ratio", float)
    sensitivity = Param("sensitivity", "sensitivity 0-99", int)
    customInterval = Param("customInterval", "custom interval", int)
    urlPath = "anomalydetector/v1.0/timeseries/last/detect"

    def _prepare_body(self, df, i):
        series = df[self.getSeriesCol()][i]
        if series is None:
            return None
        body: Dict[str, Any] = {
            "series": [dict(p) for p in series],
            "granularity": self._resolve("granularity", df, i, "monthly")}
        for name in ("maxAnomalyRatio", "sensitivity", "customInterval"):
            v = self._resolve(name, df, i)
            if v is not None:
                body[name] = v
        return body


class DetectLastAnomaly(_AnomalyBase):
    urlPath = "anomalydetector/v1.0/timeseries/last/detect"


class DetectAnomalies(_AnomalyBase):
    urlPath = "anomalydetector/v1.0/timeseries/entire/detect"


class SimpleDetectAnomalies(DetectAnomalies):
    """Groups rows into series by ``groupbyCol`` then detects batch-wise
    (reference SimpleDetectAnomalies)."""

    groupbyCol = Param("groupbyCol", "column defining series groups", str)
    timestampCol = Param("timestampCol", "timestamp column", str, "timestamp")
    valueCol = Param("valueCol", "value column", str, "value")

    def _transform(self, df: Table) -> Table:
        import numpy as np

        gcol = self.get("groupbyCol")
        if not gcol:
            return super()._transform(df)
        groups = df[gcol]
        series_col = np.empty(df.num_rows, dtype=object)
        for g in np.unique(groups):
            rows = np.flatnonzero(groups == g)
            series = [{"timestamp": str(df[self.getTimestampCol()][r]),
                       "value": float(df[self.getValueCol()][r])}
                      for r in rows]
            for r in rows:
                series_col[r] = series
        work = df.with_column(self.getSeriesCol(), series_col)
        return super()._transform(work)


class DetectMultivariateAnomaly(HasAsyncReply, _AnomalyBase):
    """Multivariate anomaly detection with the reference's train → poll →
    infer lifecycle (SimpleDetectMultivariateAnomaly). ``train`` submits the
    model and polls until ready; ``_prepare_body`` runs inference."""

    # model training takes minutes: widen the shared LRO defaults
    pollInterval = Param("pollInterval", "seconds between status polls",
                         float, 5.0)
    maxPollRetries = Param("maxPollRetries", "max status polls", int, 120)

    @staticmethod
    def _status_of(info: dict) -> str:
        # model status lives under modelInfo.status
        return str((info.get("modelInfo") or {}).get("status",
                                                     info.get("status", "")))

    def _send_raw(self, req):
        """One request without the LRO interception (train() drives its own
        modelId-aware poll loop)."""
        from .base import CognitiveServiceBase

        return CognitiveServiceBase._send_one(self, req)

    modelId = Param("modelId", "trained model id", str)
    startTime = Param("startTime", "series start (ISO)", str)
    endTime = Param("endTime", "series end (ISO)", str)
    dataSource = Param("dataSource", "blob url of training data", str)
    urlPath = "anomalydetector/v1.1/multivariate/models"

    def train(self) -> str:
        """Submit a training job and poll until READY; returns modelId."""
        base = self.get("url")
        if not base:
            raise ValueError("set url/location first")
        body = {"dataSource": self.get("dataSource"),
                "startTime": self.get("startTime"),
                "endTime": self.get("endTime")}
        resp = self._send_raw(HTTPRequestData.from_json_body(
            base, body, self._prepare_headers(None, None)))
        if resp is None or not 200 <= resp.status_code < 300:
            raise RuntimeError(f"train submit failed: "
                               f"{getattr(resp, 'status_code', None)}")
        loc = resp.headers.get("Location", "")
        model_id = loc.rstrip("/").rsplit("/", 1)[-1]
        self.set("modelId", model_id)
        status_url = loc or f"{base}/{model_id}"
        for _ in range(self.getMaxPollRetries()):
            s = self._send_raw(HTTPRequestData(
                url=status_url, method="GET",
                headers=self._prepare_headers(None, None)))
            info = s.json() if s and s.entity else {}
            status = (info.get("modelInfo") or {}).get("status", "")
            if status in ("READY", "FAILED"):
                if status == "FAILED":
                    raise RuntimeError(f"model training failed: {info}")
                return model_id
            time.sleep(self.getPollInterval())
        raise TimeoutError("model training did not finish in time")

    def _prepare_url(self, df, i):
        mid = self._resolve("modelId", df, i)
        if not mid:
            raise ValueError("modelId not set — call train() first")
        return f"{self.get('url').rstrip('/')}/{mid}:detect-last"

    def _prepare_body(self, df, i):
        series = df[self.getSeriesCol()][i]
        return {"variables": series} if series is not None else None


class DetectLastMultivariateAnomaly(DetectMultivariateAnomaly):
    """Synchronous last-point multivariate detection (reference
    DetectLastMultivariateAnomaly — POST {modelId}:detect-last)."""


class SimpleFitMultivariateAnomaly(Estimator, DetectMultivariateAnomaly):
    """Estimator facade over the train → poll lifecycle (reference
    SimpleFitMultivariateAnomaly): ``fit`` submits training, polls to READY
    and returns a SimpleDetectMultivariateAnomaly bound to the model id.
    Training reads from the ``dataSource`` blob, so ``fit()`` may be called
    without a dataframe."""

    def fit(self, df=None, params=None):
        if df is None:
            return self._fit(None)
        return super().fit(df, params)

    def _fit(self, df: Optional[Table] = None) -> "SimpleDetectMultivariateAnomaly":
        model_id = self.train()
        m = SimpleDetectMultivariateAnomaly()
        for p in ("url", "subscriptionKey", "seriesCol", "pollInterval",
                  "maxPollRetries", "handler"):
            if self.isSet(p):
                m.set(p, self.get(p))
        m.set("modelId", model_id)
        return m


class SimpleDetectMultivariateAnomaly(DetectMultivariateAnomaly):
    """Batch multivariate inference with the async result poll (reference
    SimpleDetectMultivariateAnomaly: POST {modelId}:detect-batch → resultId →
    poll results/{resultId})."""

    topContributorCount = Param("topContributorCount",
                                "contributors per anomaly", int, 10)

    def _prepare_url(self, df, i):
        mid = self._resolve("modelId", df, i)
        if not mid:
            raise ValueError("modelId not set — fit first")
        return f"{self.get('url').rstrip('/')}/{mid}:detect-batch"

    def _prepare_body(self, df, i):
        series = df[self.getSeriesCol()][i]
        if series is None:
            return None
        body = {"variables": series,
                "topContributorCount": self.getTopContributorCount()}
        for k in ("startTime", "endTime"):
            v = self._resolve(k, df, i)
            if v is not None:
                body[k] = v
        return body

    @staticmethod
    def _status_of(info: dict) -> str:
        # batch-detect results report under summary.status
        return str((info.get("summary") or {}).get("status",
                                                   info.get("status", "")))
