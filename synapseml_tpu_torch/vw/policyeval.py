"""Off-policy evaluation.

Reference: vw/.../policyeval/*.scala (Ips, Snips, CressieRead,
CressieReadInterval, PolicyEvalUDAFUtil), VowpalWabbitCSETransformer.scala,
VowpalWabbitDSJsonTransformer.scala, KahanSum.scala.

Estimators take logged bandit data (reward r, logged probability p_log, target
policy probability p_target) and estimate the target policy's value:
  - IPS:    (1/n) Σ w_i r_i,             w_i = p_target/p_log
  - SNIPS:  Σ w_i r_i / Σ w_i
  - CressieRead: empirical-likelihood reweighting (Karampatziakis et al.,
    "Empirical Likelihood for Contextual Bandits") — the robust estimator the
    reference's CressieRead UDAFs implement; the profile-likelihood interval
    gives the CressieReadInterval analog.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.table import Table


@dataclass
class KahanSum:
    """Compensated summation (reference KahanSum.scala) for long reward streams."""
    sum: float = 0.0
    c: float = 0.0

    def add(self, v: float) -> "KahanSum":
        t = self.sum + (v - self.c)
        self.c = (t - self.sum) - (v - self.c)
        self.sum = t
        return self

    def __float__(self) -> float:
        return self.sum


def _weights(p_target, p_log):
    return np.asarray(p_target, np.float64) / np.maximum(np.asarray(p_log, np.float64), 1e-12)


def ips_estimate(reward, p_log, p_target, count: Optional[np.ndarray] = None) -> float:
    w = _weights(p_target, p_log)
    r = np.asarray(reward, np.float64)
    c = np.ones_like(w) if count is None else np.asarray(count, np.float64)
    return float((w * r * c).sum() / np.maximum(c.sum(), 1.0))


def snips_estimate(reward, p_log, p_target, count: Optional[np.ndarray] = None) -> float:
    w = _weights(p_target, p_log)
    r = np.asarray(reward, np.float64)
    c = np.ones_like(w) if count is None else np.asarray(count, np.float64)
    denom = (w * c).sum()
    return float((w * r * c).sum() / denom) if denom > 0 else 0.0


def _el_beta(w: np.ndarray, n: int) -> float:
    """MLE of β in q_i ∝ 1/(1+β(w_i−1)) (empirical-likelihood tilt). Newton
    iterations on the concave log-likelihood Σ log(1+β(w_i−1))."""
    d = w - 1.0
    lo = -1.0 / max(d.max(), 1e-12) + 1e-9 if d.max() > 0 else -1e9
    hi = -1.0 / min(d.min(), -1e-12) - 1e-9 if d.min() < 0 else 1e9
    beta = 0.0
    for _ in range(50):
        z = 1.0 + beta * d
        g = (d / z).sum()
        h = -((d / z) ** 2).sum()
        if abs(g) < 1e-10 or h >= 0:
            break
        step = g / h
        beta_new = beta - step
        beta = min(max(beta_new, lo), hi)
    return beta


def cressie_read_estimate(reward, p_log, p_target) -> float:
    """Empirical-likelihood (CR-family) policy value estimate."""
    w = _weights(p_target, p_log)
    r = np.asarray(reward, np.float64)
    n = len(w)
    if n == 0:
        return 0.0
    beta = _el_beta(w, n)
    q = 1.0 / (n * (1.0 + beta * (w - 1.0)))
    # q > 0 elementwise by EL feasibility (_el_beta keeps every
    # 1 + beta*(w-1) > 0) and n == 0 returned above, so q.sum() > 0
    q = q / q.sum()  # lint-ok: nonfinite-escape positive by EL feasibility
    return float((q * w * r).sum())


def cressie_read_interval(reward, p_log, p_target, alpha: float = 0.05,
                          reward_min: float = 0.0, reward_max: float = 1.0
                          ) -> Tuple[float, float]:
    """Bootstrap-free CI: EL point estimate ± z * SNIPS influence-function SE,
    clipped to [reward_min, reward_max]. (The reference's interval is also a
    conservative EL-based band; we document the approximation.)"""
    w = _weights(p_target, p_log)
    r = np.asarray(reward, np.float64)
    n = max(len(w), 1)
    est = cressie_read_estimate(reward, p_log, p_target)
    wbar = w.mean() if n else 1.0
    infl = (w * r - est * w) / max(wbar, 1e-12)
    se = infl.std(ddof=1) / np.sqrt(n) if n > 1 else 0.0
    z = 1.959963984540054 if abs(alpha - 0.05) < 1e-9 else _z_quantile(1 - alpha / 2)
    lo, hi = est - z * se, est + z * se
    return (float(np.clip(lo, reward_min, reward_max)),
            float(np.clip(hi, reward_min, reward_max)))


def _z_quantile(p: float) -> float:
    """Acklam's inverse-normal approximation (avoids a scipy dependency)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = np.sqrt(-2 * np.log(p))  # lint-ok: nonfinite-escape — branch pins 0 < p < 0.02425, host-side
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p <= phigh:
        q = p - 0.5
        r = q * q
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
               (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    q = np.sqrt(-2 * np.log(1 - p))  # lint-ok: nonfinite-escape — branch pins p > 0.97575, host-side
    return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
           ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)


class VowpalWabbitDSJsonTransformer(Transformer):
    """Parse decision-service JSON lines into a flat table
    (VowpalWabbitDSJsonTransformer.scala): cost, logged probability, chosen
    action, action count, timestamp, eventId."""
    dsJsonColumn = Param("dsJsonColumn", "Input column of dsjson strings", str, "value")

    def _transform(self, df: Table) -> Table:
        import json
        rows = []
        for line in df[self.dsJsonColumn]:
            try:
                d = json.loads(line)
            except (json.JSONDecodeError, TypeError):
                continue
            rows.append({
                "EventId": d.get("EventId", ""),
                "Timestamp": d.get("Timestamp", ""),
                "cost": float(d.get("_label_cost", 0.0)),
                "probability": float(d.get("_label_probability", 1.0)),
                # 1-based, to chain directly into VowpalWabbitContextualBandit's
                # chosenActionCol (_labelIndex is 0-based, _label_Action 1-based)
                "chosenAction": (int(d["_labelIndex"]) + 1 if "_labelIndex" in d
                                 else int(d.get("_label_Action", 1))),
                "numActions": len(d.get("a", [])) or len(d.get("p", [])),
                "probabilities": list(map(float, d.get("p", []))),
                "actions": list(map(int, d.get("a", []))),
            })
        return Table.from_rows(rows)


class VowpalWabbitCSETransformer(Transformer):
    """Counterfactual (side-by-side) evaluation over parsed dsjson rows
    (VowpalWabbitCSETransformer.scala): given logged (cost, prob) and a target
    policy's per-example probability column, emit the per-metric estimates as a
    one-row summary table with min/max reward normalization."""
    rewardCol = Param("rewardCol", "Reward column (cost is negated upstream)", str, "reward")
    probabilityLoggedCol = Param("probabilityLoggedCol", "Logged prob col", str, "probability")
    probabilityPredictedCol = Param("probabilityPredictedCol", "Target-policy prob col",
                                    str, "probabilityPredicted")
    minImportanceWeight = Param("minImportanceWeight", "Clip weights below", float, 0.0)
    maxImportanceWeight = Param("maxImportanceWeight", "Clip weights above", float, 100.0)

    def _transform(self, df: Table) -> Table:
        r = np.asarray(df[self.rewardCol], np.float64)
        pl = np.asarray(df[self.probabilityLoggedCol], np.float64)
        pt = np.asarray(df[self.probabilityPredictedCol], np.float64)
        w = np.clip(pt / np.maximum(pl, 1e-12),
                    self.minImportanceWeight, self.maxImportanceWeight)
        n = max(len(r), 1)
        snips_denom = w.sum()
        rmin, rmax = (float(r.min()), float(r.max())) if len(r) else (0.0, 1.0)
        lo, hi = cressie_read_interval(r, pl, pt, reward_min=rmin, reward_max=rmax)
        return Table({
            "exampleCount": np.array([len(r)], np.int64),
            "ips": np.array([(w * r).sum() / n]),
            "snips": np.array([(w * r).sum() / snips_denom if snips_denom > 0 else 0.0]),
            "cressieRead": np.array([cressie_read_estimate(r, pl, pt)]),
            "cressieReadLower": np.array([lo]),
            "cressieReadUpper": np.array([hi]),
            "averageWeight": np.array([w.mean() if len(w) else 0.0]),
            "maxWeight": np.array([w.max() if len(w) else 0.0]),
        })
