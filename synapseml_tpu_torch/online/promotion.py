"""Counterfactually-gated promotion: candidates earn the hot-swap.

The online learner produces a stream of candidate policy snapshots; this
gate decides which of them reach traffic. The decision is OFF-POLICY: the
candidate is scored against the live policy's propensity-logged
interactions with the ``vw/policyeval`` estimators — no A/B traffic is
risked on an unproven policy. The rule is deliberately one-sided:

    promote  iff  CR_lower(candidate) > value(incumbent) + min_improvement

where ``CR_lower`` is the Cressie-Read (empirical-likelihood) interval's
lower bound on the candidate's value (clipped importance weights, à la the
CSE transformer's ``maxImportanceWeight``), and the incumbent's value is
the plain mean of its own logged rewards (the logs ARE on-policy for the
incumbent, so no importance correction is needed or wanted). A noisy,
wide-interval candidate fails the gate by construction — the gate prefers
serving a known-good policy over gambling on an estimated-better one.

Promotion itself rides :meth:`~synapseml_tpu_torch.io.serving.ModelRegistry.swap_to`
(zero-downtime, pre-flip failures roll back with the incumbent still
serving), and every promoted version lands in ``approved_versions`` — the
set the chaos invariant checks every served response against. After a flip
the gate watches LIVE reward through :meth:`observe_live`; a regression
beyond tolerance triggers :meth:`~synapseml_tpu_torch.io.serving.ModelRegistry.rollback`
to the previous (also-approved) version. Counterfactual estimates are
estimates; the live check is the backstop.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..core.logging import record_failure
from ..io.serving import ModelRegistry, SwapError
from ..vw.policyeval import cressie_read_interval, snips_estimate
from .feedback import FeedbackEvent


@dataclass(frozen=True)
class GateDecision:
    """One gate verdict — every field the audit trail needs."""
    candidate_version: Optional[str]
    promoted: bool
    reason: str
    n_samples: int = 0
    incumbent_value: float = 0.0
    snips: float = 0.0
    interval: Tuple[float, float] = (0.0, 0.0)


class PromotionGate:
    """Off-policy promotion gate + post-promotion live-regression watchdog.

    Feed it the SAME accepted interactions the learner trains on
    (:meth:`record`); ask it to judge a candidate serving handler
    (:meth:`decide`) or to load→judge→swap in one motion
    (:meth:`try_promote`). The gate never raises on a failed or killed
    swap — a refused candidate is a normal outcome, reported in the
    returned :class:`GateDecision`, and the incumbent keeps serving.
    """

    # min_improvement's default is epsilon, not zero: a degenerate interval
    # sitting exactly on the incumbent's value must not promote on float
    # rounding noise
    def __init__(self, registry: ModelRegistry,
                 min_samples: int = 200, alpha: float = 0.05,
                 min_improvement: float = 1e-6, max_weight: float = 100.0,
                 reward_min: float = 0.0, reward_max: float = 1.0,
                 log_window: int = 4096,
                 regression_window: int = 100,
                 regression_tolerance: float = 0.05,
                 broadcast=None):
        if min_samples < 2:
            raise ValueError(f"min_samples must be >= 2, got {min_samples}")
        if max_weight <= 0:
            raise ValueError(f"max_weight must be > 0, got {max_weight}")
        self.registry = registry
        # fabric-wide promotion: a PromotionBroadcast (io/distributed_
        # serving.py) whose two-phase prepare/commit flips EVERY worker to
        # the approved version, rolling all of them back on any failure —
        # None keeps the single-registry swap_to path
        self.broadcast = broadcast
        self.min_samples = min_samples
        self.alpha = alpha
        self.min_improvement = min_improvement
        self.max_weight = max_weight
        self.reward_min = reward_min
        self.reward_max = reward_max
        self.regression_window = regression_window
        self.regression_tolerance = regression_tolerance
        self._lock = threading.Lock()
        self._logs: deque = deque(maxlen=log_window)
        # the version serving at construction is approved by fiat: it is the
        # incumbent every later candidate must beat
        self.approved_versions = {registry.active}
        self.decisions: List[GateDecision] = []
        self.promotions = 0
        self.rollbacks = 0
        # live-regression watchdog state (armed by a successful promotion)
        self._baseline: Optional[float] = None
        self._live: deque = deque(maxlen=regression_window)

    # -- evidence intake --
    def record(self, ev: FeedbackEvent) -> None:
        """Log one incumbent interaction (propensity + reward) as gate
        evidence. Call with the same validated events the learner drains."""
        with self._lock:
            self._logs.append(ev)

    def record_all(self, events) -> None:
        with self._lock:
            self._logs.extend(events)

    # -- judgement --
    def _columns(self, candidate_policy):
        """(reward, p_log, p_target) over the logged window, with the
        importance ratio clipped at ``max_weight`` — implemented by flooring
        the logged propensity, so the library estimators see the clipped
        weights without a separate code path."""
        with self._lock:
            logs = list(self._logs)
        r = np.asarray([float(ev.reward) for ev in logs], np.float64)
        p_log = np.asarray([float(ev.probability) for ev in logs], np.float64)
        p_tgt = np.asarray(
            [float(candidate_policy.action_probabilities(ev.actions)
                   [int(ev.action) - 1]) for ev in logs], np.float64)
        p_log = np.maximum(p_log, p_tgt / self.max_weight)
        return r, p_log, p_tgt

    def decide(self, candidate_handler, version: Optional[str] = None
               ) -> GateDecision:
        """Judge a candidate handler (as built by ``policy_builder``)
        against the logged evidence. Pure read — no swap happens here."""
        version = version if version is not None \
            else getattr(candidate_handler, "version", None)
        policy = getattr(candidate_handler, "policy", candidate_handler)
        with self._lock:
            n = len(self._logs)
        if n < self.min_samples:
            return self._finish(GateDecision(
                version, False, "insufficient_samples", n_samples=n))
        r, p_log, p_tgt = self._columns(policy)
        incumbent = float(r.mean())
        snips = snips_estimate(r, p_log, p_tgt)
        lo, hi = cressie_read_interval(
            r, p_log, p_tgt, alpha=self.alpha,
            reward_min=self.reward_min, reward_max=self.reward_max)
        promoted = lo > incumbent + self.min_improvement
        reason = "interval_clears_incumbent" if promoted \
            else "interval_overlaps_incumbent"
        return self._finish(GateDecision(
            version, promoted, reason, n_samples=n,
            incumbent_value=incumbent, snips=snips, interval=(lo, hi)))

    def _finish(self, decision: GateDecision) -> GateDecision:
        with self._lock:
            self.decisions.append(decision)
        if not decision.promoted:
            record_failure("online.gate_refused", n=1,
                           version=str(decision.candidate_version),
                           reason=decision.reason)
        return decision

    # -- promotion --
    def try_promote(self, store, builder: Callable,
                    step: Optional[int] = None) -> GateDecision:
        """Load the newest verifiable candidate snapshot, judge it, and —
        only on a clear verdict — hot-swap it in. Every failure mode
        (corrupt snapshot, builder error, injected kill mid-swap) comes back
        as a non-promoted decision with the incumbent still serving."""
        try:
            ckpt = (store.load_step(step) if step is not None
                    else store.load_latest())
        except Exception as e:  # noqa: BLE001 — a broken store refuses, not raises
            return self._finish(GateDecision(
                None, False, f"load_failed:{type(e).__name__}"))
        if ckpt is None:
            return self._finish(GateDecision(
                None, False, "no_verifiable_checkpoint"))
        if ckpt.version == self.registry.active:
            return self._finish(GateDecision(
                ckpt.version, False, "already_serving"))
        try:
            handler = builder(ckpt)
        except Exception as e:  # noqa: BLE001
            return self._finish(GateDecision(
                ckpt.version, False, f"build_failed:{type(e).__name__}"))
        decision = self.decide(handler, version=ckpt.version)
        if not decision.promoted:
            return decision
        try:
            if self.broadcast is not None:
                # fabric-wide: one gate approval flips every worker via
                # two-phase prepare/commit; any failure path converges the
                # whole fabric on ONE version (BroadcastError = old one)
                self.broadcast.broadcast(ckpt.version, handler)
            else:
                self.registry.swap_to(ckpt.version, handler)
        except (SwapError, RuntimeError) as e:
            # pre-flip failure (chaos kill, warmup fault) or a rolled-back
            # broadcast: the incumbent version serves on, fabric-wide
            with self._lock:
                self.decisions.pop()
            return self._finish(GateDecision(
                ckpt.version, False, "swap_failed",
                n_samples=decision.n_samples,
                incumbent_value=decision.incumbent_value,
                snips=decision.snips, interval=decision.interval))
        with self._lock:
            self.approved_versions.add(ckpt.version)
            self.promotions += 1
            # arm the watchdog: live reward must hold the incumbent's level
            self._baseline = decision.incumbent_value
            self._live.clear()
        record_failure("online.gate_promoted", version=ckpt.version)
        return decision

    def recover_broadcast(self) -> Optional[str]:
        """Drive a DEAD coordinator's in-doubt promotion round to its end
        (federated fabric): delegates to
        :meth:`~synapseml_tpu_torch.io.distributed_serving.PromotionBroadcast.
        recover`, which reads the replicated 2PC phase record and converges
        every worker on exactly one version. A recovered COMMIT joins
        ``approved_versions`` — the round's prepare record only exists
        because the dead coordinator's gate approved the candidate, and the
        chaos invariant checks served versions against the survivor's gate.
        Returns the outcome (``"committed"``/``"aborted"``) or None when
        there is nothing to recover."""
        recover = getattr(self.broadcast, "recover", None)
        if recover is None:
            return None
        recovered = recover()
        if recovered is None:
            return None
        version, outcome = recovered
        if outcome == "committed":
            with self._lock:
                self.approved_versions.add(version)
                self.promotions += 1
        record_failure("online.broadcast_recovered", version=version,
                       outcome=outcome)
        return outcome

    # -- post-promotion live watchdog --
    def observe_live(self, reward: float) -> bool:
        """Feed one post-promotion LIVE reward. Once the regression window
        fills, a live mean below ``baseline - regression_tolerance`` rolls
        back to the previous approved version. Returns True iff this
        observation triggered a rollback."""
        with self._lock:
            if self._baseline is None:
                return False
            self._live.append(float(reward))
            if len(self._live) < self.regression_window:
                return False
            live_mean = float(np.mean(self._live))
            baseline = self._baseline
            if live_mean >= baseline - self.regression_tolerance:
                self._baseline = None    # candidate confirmed; disarm
                return False
            # regression: disarm before the swap so re-entry is impossible
            self._baseline = None
        demoted = self.registry.active
        try:
            self.registry.rollback()
        except SwapError as e:
            record_failure("online.rollback_failed", error=type(e).__name__)
            return False
        with self._lock:
            self.rollbacks += 1
        record_failure("online.live_regression_rollback", version=demoted,
                       live_mean=round(live_mean, 6),
                       baseline=round(baseline, 6))
        return True

    def snapshot(self) -> dict:
        with self._lock:
            return {"logs": len(self._logs),
                    "decisions": len(self.decisions),
                    "promotions": self.promotions,
                    "rollbacks": self.rollbacks,
                    "approved": sorted(self.approved_versions),
                    "watchdog_armed": self._baseline is not None}
