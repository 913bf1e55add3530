"""Streaming anomaly scoring on the online-loop skeleton.

The same drain→update→snapshot skeleton that powers the contextual-bandit
learner (``online/loop.py``) also carries the batch anomaly detectors into
continuous operation: events stream through a
:class:`~synapseml_tpu_torch.online.feedback.FeedbackLog` (with an
anomaly-specific validator — there is no reward/propensity to range-check,
only finite features), a frozen batch-trained model scores each micro-batch,
and the alert threshold ADAPTS to a rolling quantile of recent scores so a
drifting score distribution does not silently mute (or flood) the alert
channel. Window + threshold + counters snapshot through the same
digest-verified :class:`~synapseml_tpu_torch.core.checkpoint.CheckpointStore`,
so kill→resume replays bit-for-bit exactly like the learner loop.

The scorer is any function of a micro-batch of events returning one
score per event. The JAX package's two adapters for its detectors
(:func:`iforest_stream_scorer` for the isolation forest,
:func:`access_anomaly_stream_scorer` for access anomaly) wait for those
detectors' port and refuse by name.
"""

from __future__ import annotations

import io as _io
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from .feedback import FeedbackLog
from .loop import StreamLoop


@dataclass(frozen=True)
class AnomalyEvent:
    """One record awaiting an anomaly score. ``features`` is whatever the
    configured scorer consumes: a dense vector for the isolation forest, a
    ``{"tenant", "user", "res"}`` mapping for access anomaly."""
    key: str
    features: object
    meta: dict = field(default_factory=dict, compare=False)


def validate_anomaly_event(ev) -> Optional[str]:
    """Quarantine reason for a streaming-anomaly event, or None."""
    feats = getattr(ev, "features", None)
    if feats is None:
        return "malformed"
    if isinstance(feats, dict):
        return None
    try:
        arr = np.asarray(feats, np.float64)
    except (TypeError, ValueError):
        return "malformed"
    if arr.size == 0:
        return "malformed"
    if not np.isfinite(arr).all():
        return "nonfinite_features"
    return None


def anomaly_feedback_log(capacity: int = 4096, dedup_window: int = 8192,
                         **kw) -> FeedbackLog:
    """A :class:`FeedbackLog` wired for anomaly events (same bounding,
    dedup, and shed-oldest semantics; anomaly validator)."""
    return FeedbackLog(capacity=capacity, dedup_window=dedup_window,
                       validator=validate_anomaly_event,
                       counter_prefix=kw.pop("counter_prefix",
                                             "online.anomaly"), **kw)


class StreamingAnomalyLoop(StreamLoop):
    """Score → threshold-adapt → snapshot.

    Each micro-batch is scored by the frozen ``scorer``, flagged against the
    threshold that was in force BEFORE the batch (so flagging is causal and
    replay-deterministic), then the rolling window absorbs the new scores
    and the threshold re-adapts to ``quantile(window, 1 - contamination)``.
    Until ``min_window`` scores have been seen the loop scores but never
    flags — a cold quantile over three points is noise, not a threshold."""

    phase = "online.anomaly"
    counter_prefix = "online.anomaly"
    WINDOW_ARTIFACT = "anomaly_window.npz"

    def __init__(self, log: FeedbackLog,
                 scorer: Callable[[List[AnomalyEvent]], np.ndarray],
                 window: int = 512, contamination: float = 0.05,
                 min_window: int = 32,
                 on_alert: Optional[Callable[[AnomalyEvent, float], None]] = None,
                 **kw):
        super().__init__(log, **kw)
        if not (0.0 < contamination < 1.0):
            raise ValueError(
                f"contamination must be in (0, 1), got {contamination}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.scorer = scorer
        self.window = window
        self.contamination = contamination
        self.min_window = max(int(min_window), 1)
        self.on_alert = on_alert
        self._scores: deque = deque(maxlen=window)
        self.threshold = math.inf    # flag nothing until the window warms up
        self.scored = 0
        self.flagged = 0

    def _update(self, events: List[AnomalyEvent]) -> None:
        scores = np.asarray(self.scorer(events), np.float64).reshape(-1)
        if scores.shape[0] != len(events):
            raise ValueError(
                f"scorer returned {scores.shape[0]} scores for "
                f"{len(events)} events")
        thr = self.threshold            # causal: pre-batch threshold
        for ev, s in zip(events, scores):
            self.scored += 1
            if s >= thr:
                self.flagged += 1
                if self.on_alert is not None:
                    self.on_alert(ev, float(s))
        self._scores.extend(scores.tolist())
        if len(self._scores) >= self.min_window:
            self.threshold = float(np.quantile(
                np.asarray(self._scores, np.float64),
                1.0 - self.contamination))

    def _artifacts(self) -> dict:
        buf = _io.BytesIO()
        np.savez(buf,
                 scores=np.asarray(self._scores, np.float64),
                 threshold=np.float64(self.threshold),
                 scored=np.int64(self.scored),
                 flagged=np.int64(self.flagged))
        return {self.WINDOW_ARTIFACT: buf.getvalue()}

    def _restore(self, ckpt) -> None:
        data = ckpt.artifacts.get(self.WINDOW_ARTIFACT)
        if data is None:
            raise ValueError(
                f"checkpoint {ckpt.base} holds no "
                f"{self.WINDOW_ARTIFACT!r} artifact")
        try:
            with np.load(_io.BytesIO(bytes(data)), allow_pickle=False) as z:
                scores = np.asarray(z["scores"], np.float64)
                self.threshold = float(z["threshold"])
                self.scored = int(z["scored"])
                self.flagged = int(z["flagged"])
        except (KeyError, ValueError, OSError, EOFError) as e:
            raise ValueError(
                f"checkpoint {ckpt.base}: anomaly window artifact is not a "
                f"valid npz payload ({e})") from e
        self._scores = deque(scores.tolist(), maxlen=self.window)

    def snapshot_stats(self) -> dict:
        stats = super().snapshot_stats()
        stats.update({"scored": self.scored, "flagged": self.flagged,
                      "threshold": self.threshold,
                      "window_fill": len(self._scores)})
        return stats


def iforest_stream_scorer(model) -> Callable[[List[AnomalyEvent]], np.ndarray]:
    """Adapt a trained ``IsolationForestModel`` to the streaming loop. Not
    ported: the isolation forest is not in the PyTorch package yet, so this
    raises ``NotImplementedError`` naming itself."""
    raise NotImplementedError(
        "iforest_stream_scorer is not ported to the PyTorch package yet (it "
        "needs isolationforest/); pass StreamingAnomalyLoop a scorer "
        "function of the events instead")


def access_anomaly_stream_scorer(model) -> Callable[[List[AnomalyEvent]], np.ndarray]:
    """Adapt a trained ``AccessAnomalyModel`` to the streaming loop. Not
    ported: the access-anomaly model is not in the PyTorch package yet, so
    this raises ``NotImplementedError`` naming itself."""
    raise NotImplementedError(
        "access_anomaly_stream_scorer is not ported to the PyTorch package "
        "yet (it needs cyber/); pass StreamingAnomalyLoop a scorer function "
        "of the events instead")
