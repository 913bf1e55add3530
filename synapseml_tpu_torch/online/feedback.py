"""Bounded, back-pressured feedback log — the serving→training ingress.

The serving tier emits ``(context, action, probability, reward)`` events;
real reward pipelines deliver them late, twice, or poisoned (NaN joins,
out-of-range metric bugs — exactly what ``testing.chaos.chaos_reward_stream``
injects). This log is the containment layer between that stream and the
online learner:

* **Bounded, never blocking** — a fixed-capacity ring; on overflow the
  OLDEST unconsumed event is shed (``shed_oldest`` counter) so the serving
  hot path never waits on the training side. Stale feedback is the cheapest
  feedback to lose.
* **Dedup** — a bounded LRU of recently-seen event keys; a duplicate key is
  counted (``duplicates``) and dropped, so at-least-once delivery upstream
  cannot double-count a reward into the learner or the gate's logs.
* **Quarantine** — events that fail validation (non-finite or out-of-range
  reward, propensity outside ``(0, 1]``, missing/out-of-range action) are
  counted per reason (``quarantined``) and never reach the learner. A NaN
  reward burst degrades to zero learning signal, not NaN weights.

Thread-safe: serving connection threads ``offer`` concurrently while the
learner loop ``drain``\\ s. Counters are the observable surface the chaos
suite asserts on.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ..core.logging import record_failure


@dataclass(frozen=True)
class FeedbackEvent:
    """One logged bandit interaction.

    ``actions`` holds the per-action featurized sparse rows (the
    ``SPARSE_DTYPE`` rows the VW featurizer/estimators use — one row per
    available action, shared context already folded in); ``action`` is the
    1-based chosen index, ``probability`` the logging policy's propensity
    for that choice, ``reward`` the observed outcome. ``key`` is the dedup
    identity (the dsjson ``EventId`` analog)."""
    key: str
    actions: Sequence
    action: int
    probability: float
    reward: float
    meta: dict = field(default_factory=dict, compare=False)


def validate_bandit_event(ev: FeedbackEvent, reward_min: float,
                          reward_max: float) -> Optional[str]:
    """Returns a quarantine reason, or None for a clean event."""
    try:
        r = float(ev.reward)
        p = float(ev.probability)
        a = int(ev.action)
    except (TypeError, ValueError):
        return "malformed"
    if not math.isfinite(r):
        return "nonfinite_reward"
    if r < reward_min or r > reward_max:
        return "reward_out_of_range"
    if not (0.0 < p <= 1.0):
        return "bad_propensity"
    n_actions = len(ev.actions) if ev.actions is not None else 0
    if n_actions == 0 or not (1 <= a <= n_actions):
        return "bad_action"
    return None


class FeedbackLog:
    """Bounded dedup'ing quarantine queue between serving and the learner.

    ``offer`` never blocks and returns one of ``"accepted"``,
    ``"duplicate"``, ``"quarantined"``; ``drain(max_n)`` pops up to
    ``max_n`` oldest events FIFO. ``validator(event) -> reason|None``
    defaults to the contextual-bandit rules; the streaming-anomaly loop
    passes its own.
    """

    def __init__(self, capacity: int = 4096, dedup_window: int = 8192,
                 reward_min: float = 0.0, reward_max: float = 1.0,
                 validator: Optional[Callable] = None,
                 counter_prefix: str = "online.feedback"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.dedup_window = max(int(dedup_window), 0)
        self.reward_min = reward_min
        self.reward_max = reward_max
        self._validator = validator
        self._prefix = counter_prefix
        self._lock = threading.Lock()
        self._events: deque = deque()
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self.accepted = 0
        self.duplicates = 0
        self.shed_oldest = 0
        self.drained = 0
        self.quarantined: Dict[str, int] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def _validate(self, ev) -> Optional[str]:
        if self._validator is not None:
            return self._validator(ev)
        return validate_bandit_event(ev, self.reward_min, self.reward_max)

    def offer(self, ev) -> str:
        """Admit one event; sheds the OLDEST queued event on overflow
        instead of blocking or refusing the new one (fresh feedback beats
        stale feedback, and the serving thread never waits)."""
        reason = self._validate(ev)
        if reason is not None:
            with self._lock:
                self.quarantined[reason] = self.quarantined.get(reason, 0) + 1
            record_failure(f"{self._prefix}.quarantined", reason=reason,
                           key=str(getattr(ev, "key", "")))
            return "quarantined"
        key = getattr(ev, "key", None)
        with self._lock:
            if key is not None and self.dedup_window:
                if key in self._seen:
                    self._seen.move_to_end(key)
                    self.duplicates += 1
                    record_failure(f"{self._prefix}.duplicate", key=str(key))
                    return "duplicate"
                self._seen[key] = None
                while len(self._seen) > self.dedup_window:
                    self._seen.popitem(last=False)
            while len(self._events) >= self.capacity:
                self._events.popleft()
                self.shed_oldest += 1
                record_failure(f"{self._prefix}.shed_oldest")
            self._events.append(ev)
            self.accepted += 1
        return "accepted"

    def drain(self, max_n: int) -> List:
        """Pop up to ``max_n`` events, oldest first (never blocks)."""
        out: List = []
        with self._lock:
            while self._events and len(out) < int(max_n):
                out.append(self._events.popleft())
            self.drained += len(out)
        return out

    def clear(self) -> int:
        """Drop every queued event (close-time hygiene); returns the count
        dropped so callers can account for them."""
        with self._lock:
            n = len(self._events)
            self._events.clear()
        return n

    def snapshot(self) -> dict:
        with self._lock:
            return {"depth": len(self._events),
                    "accepted": self.accepted,
                    "duplicates": self.duplicates,
                    "shed_oldest": self.shed_oldest,
                    "drained": self.drained,
                    "quarantined": dict(self.quarantined)}
