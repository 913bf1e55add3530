"""Balance measures over sensitive features.

Reference formulas (FeatureBalanceMeasure.scala:228-266,
DistributionBalanceMeasure.scala:227-260, AggregateBalanceMeasure.scala:125-160):

* **FeatureBalanceMeasure** — for each sensitive column and each pair of its
  values (A, B), the gap ``M(A) − M(B)`` for association measures M computed
  from p(x)=P(feature=x), p(y)=P(label positive), p(x,y):
  dp = p(x,y)/p(x); sdc = p(x,y)/(p(x)+p(y)); ji = p(x,y)/(p(x)+p(y)−p(x,y));
  llr = ln(p(x,y)/p(y)); pmi = ln(dp); n_pmi_y = pmi/ln p(y);
  n_pmi_xy = pmi/ln p(x,y); s_pmi = ln(p(x,y)²/(p(x)p(y)));
  krc (Kendall rank proxy) and t_test = (p(x,y)−p(x)p(y))/√(p(x)p(y)).
* **DistributionBalanceMeasure** — per sensitive column, observed value
  distribution vs a reference (uniform by default): KL divergence, JS
  distance, inf-norm, total variation, Wasserstein-1, χ² statistic + p-value.
* **AggregateBalanceMeasure** — inequality indices over all value
  probabilities: Atkinson index (ε), Theil L, Theil T.

The port's copy of the JAX package's ``exploratory/balance.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.params import Param, HasLabelCol
from ..core.pipeline import Transformer
from ..core.table import Table

_EPS = 1e-12


class _BalanceBase(Transformer):
    sensitiveCols = Param("sensitiveCols", "sensitive feature columns", list)
    verbose = Param("verbose", "include all intermediate measures", bool, False)

    def _probs(self, df: Table, col: str):
        vals, counts = np.unique(df[col], return_counts=True)
        return vals, counts / df.num_rows


class FeatureBalanceMeasure(_BalanceBase, HasLabelCol):
    """Pairwise association gaps between sensitive-feature values
    (reference FeatureBalanceMeasure.scala:38-200)."""

    outputCol = Param("outputCol", "output measures column", str,
                      "FeatureBalanceMeasure")

    def _measures(self, p_x: float, p_y: float, p_xy: float) -> Dict[str, float]:
        dp = p_xy / max(p_x, _EPS)
        pmi = np.log(dp) if dp > 0 else -np.inf
        return {
            "dp": dp,
            "sdc": p_xy / max(p_x + p_y, _EPS),
            "ji": p_xy / max(p_x + p_y - p_xy, _EPS),
            "llr": np.log(max(p_xy, _EPS) / max(p_y, _EPS)),
            "pmi": pmi,
            "n_pmi_y": 0.0 if p_y <= 0 else pmi / np.log(max(p_y, _EPS)),
            "n_pmi_xy": 0.0 if p_xy <= 0 else pmi / np.log(max(p_xy, _EPS)),
            "s_pmi": 0.0 if p_x * p_y <= 0 else np.log(
                max(p_xy, _EPS) ** 2 / (p_x * p_y)),
            "krc": _krc(p_x, p_y, p_xy),
            "t_test": (p_xy - p_x * p_y) / np.sqrt(max(p_x * p_y, _EPS)),
        }

    def _transform(self, df: Table) -> Table:
        label = np.asarray(df[self.getLabelCol()], np.float64) > 0
        p_y = float(label.mean())
        rows = []
        for col in (self.get("sensitiveCols") or []):
            vals, probs = self._probs(df, col)
            per_val = {}
            for v, p_x in zip(vals, probs):
                sel = df[col] == v
                p_xy = float((sel & label).mean())
                per_val[v] = self._measures(float(p_x), p_y, p_xy)
            for i in range(len(vals)):
                for j in range(i + 1, len(vals)):
                    a, b = vals[i], vals[j]
                    gaps = {k: per_val[a][k] - per_val[b][k]
                            for k in per_val[a]}
                    rows.append({"FeatureName": col, "ClassA": a, "ClassB": b,
                                 **gaps})
        return Table.from_rows(rows) if rows else Table(
            {"FeatureName": np.array([], object)})


def _krc(p_x: float, p_y: float, p_xy: float) -> float:
    """Kendall rank correlation proxy (reference FeatureBalanceMeasure:255-263)."""
    a = p_xy - p_x * p_y
    denom = np.sqrt(max(p_x * (1 - p_x) * p_y * (1 - p_y), _EPS))
    return a / denom


class DistributionBalanceMeasure(_BalanceBase):
    """Observed vs reference distribution per sensitive column
    (reference DistributionBalanceMeasure.scala:41-214)."""

    outputCol = Param("outputCol", "output measures column", str,
                      "DistributionBalanceMeasure")
    referenceDistribution = Param(
        "referenceDistribution",
        "list of {value: prob} dicts per sensitive col (default uniform)",
        is_complex=True)

    def _transform(self, df: Table) -> Table:
        refs: Optional[List[dict]] = self.get("referenceDistribution")
        rows = []
        for ci, col in enumerate(self.get("sensitiveCols") or []):
            vals, obs = self._probs(df, col)
            n = len(vals)
            if refs is not None and ci < len(refs) and refs[ci]:
                ref = np.asarray([refs[ci].get(
                    v.item() if isinstance(v, np.generic) else v, 0.0)
                    for v in vals])
            else:
                ref = np.full(n, 1.0 / n)
            kl = float(np.sum(obs * np.log(np.maximum(obs, _EPS)
                                           / np.maximum(ref, _EPS))))
            m = 0.5 * (obs + ref)
            js = float(np.sqrt(max(
                0.5 * np.sum(obs * np.log(np.maximum(obs, _EPS) / m))
                + 0.5 * np.sum(ref * np.log(np.maximum(ref, _EPS) / m)), 0.0)))
            inf_norm = float(np.max(np.abs(obs - ref)))
            tv = float(0.5 * np.sum(np.abs(obs - ref)))
            wasserstein = float(np.mean(np.abs(np.cumsum(obs) - np.cumsum(ref))))
            counts = obs * df.num_rows
            expected = ref * df.num_rows
            chi2 = float(np.sum((counts - expected) ** 2
                                / np.maximum(expected, _EPS)))
            p_value = float(_chi2_sf(chi2, max(n - 1, 1)))
            rows.append({"FeatureName": col, "kl_divergence": kl,
                         "js_dist": js, "inf_norm_dist": inf_norm,
                         "total_variation_dist": tv,
                         "wasserstein_dist": wasserstein,
                         "chi_sq_stat": chi2, "chi_sq_p_value": p_value})
        return Table.from_rows(rows) if rows else Table(
            {"FeatureName": np.array([], object)})


def _chi2_sf(x: float, k: int) -> float:
    """Chi-square survival function via the regularized upper incomplete gamma
    (series/continued-fraction, no scipy dependency)."""
    import math

    if x <= 0:
        return 1.0
    a, half_x = k / 2.0, x / 2.0
    # P(a, x) lower regularized via series; Q = 1 - P (swap for large x)
    if half_x < a + 1:
        term = 1.0 / a
        total = term
        n = 0
        while abs(term) > 1e-12 * abs(total) and n < 500:
            n += 1
            term *= half_x / (a + n)
            total += term
        p = total * math.exp(-half_x + a * math.log(half_x) - math.lgamma(a))
        return max(0.0, min(1.0, 1.0 - p))
    # continued fraction for Q(a, x)
    b = half_x + 1.0 - a
    c = 1e300
    d = 1.0 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        d = 1.0 / (d if abs(d) > 1e-300 else 1e-300)
        c = b + an / (c if abs(c) > 1e-300 else 1e-300)
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-12:
            break
    q = h * math.exp(-half_x + a * math.log(half_x) - math.lgamma(a))
    return max(0.0, min(1.0, q))


class AggregateBalanceMeasure(_BalanceBase):
    """Inequality indices over the joint sensitive-value distribution
    (reference AggregateBalanceMeasure.scala:30-160)."""

    outputCol = Param("outputCol", "output measures column", str,
                      "AggregateBalanceMeasure")
    epsilon = Param("epsilon", "Atkinson inequality-aversion parameter",
                    float, 1.0)

    def _transform(self, df: Table) -> Table:
        cols = self.get("sensitiveCols") or []
        if not cols:
            return Table({"atkinson_index": np.array([])})
        # joint distribution over the cross product of sensitive values;
        # \x1f separator keeps distinct tuples from colliding after join
        keys = ["\x1f".join(str(df[c][i]) for c in cols)
                for i in range(df.num_rows)]
        _, counts = np.unique(np.asarray(keys), return_counts=True)
        p = counts / counts.sum()
        n = len(p)
        mu = p.mean()
        eps = self.getEpsilon()
        if abs(eps - 1.0) < 1e-12:
            atkinson = 1.0 - float(np.exp(np.mean(np.log(
                np.maximum(p, _EPS)))) / mu)
        else:
            atkinson = 1.0 - float(
                (np.mean(np.maximum(p, _EPS) ** (1 - eps)))
                ** (1.0 / (1 - eps)) / mu)
        theil_l = float(np.mean(np.log(np.maximum(mu / np.maximum(p, _EPS),
                                                  _EPS))))
        theil_t = float(np.mean(p / mu * np.log(np.maximum(p / mu, _EPS))))
        return Table({"atkinson_index": np.array([atkinson]),
                      "theil_l_index": np.array([theil_l]),
                      "theil_t_index": np.array([theil_t]),
                      "num_unique_values": np.array([n])})
