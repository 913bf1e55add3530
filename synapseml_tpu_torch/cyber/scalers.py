"""Per-partition scalar scalers.

A copy of the JAX package's ``cyber/scalers.py`` (host numpy; the port
imports nothing of that package). Reference: cyber/feature/scalers.py —
StandardScalarScaler (z-score per partition/tenant, optional target
mean/std) and LinearScalarScaler (min-max to a required range per
partition).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..core.params import Param, Params
from ..core.pipeline import Estimator, Model
from ..core.table import Table


class _ScalerParams(Params):
    inputCol = Param("inputCol", "column to scale", str)
    partitionKey = Param("partitionKey", "tenant column", str)
    outputCol = Param("outputCol", "scaled output column", str)


def _per_partition(df: Table, params: _ScalerParams, stat_fn) -> Dict[Any, tuple]:
    part = df[params.getPartitionKey()]
    vals = np.asarray(df[params.getInputCol()], dtype=np.float64)
    stats: Dict[Any, tuple] = {}
    for p in np.unique(part):
        key = p.item() if isinstance(p, np.generic) else p
        stats[key] = stat_fn(vals[part == p])
    return stats


def _apply(df: Table, params: _ScalerParams, stats, map_fn) -> Table:
    part = df[params.getPartitionKey()]
    vals = np.asarray(df[params.getInputCol()], dtype=np.float64)
    out = np.zeros_like(vals)
    for i, (p, v) in enumerate(zip(part, vals)):
        key = p.item() if isinstance(p, np.generic) else p
        out[i] = map_fn(stats[key], v) if key in stats else v
    return df.with_column(params.getOutputCol(), out)


class StandardScalarScaler(Estimator, _ScalerParams):
    coefficientFactor = Param("coefficientFactor", "multiply the standardized "
                              "value", float, 1.0)
    targetMean = Param("targetMean", "mean after scaling", float, 0.0)
    targetStd = Param("targetStd", "std after scaling", float, 1.0)

    def _fit(self, df: Table) -> "StandardScalarScalerModel":
        stats = _per_partition(df, self, lambda v: (float(v.mean()),
                                                    float(v.std()) or 1.0))
        return StandardScalarScalerModel(
            stats=stats, **{p: self.get(p) for p in self._paramMap})


class StandardScalarScalerModel(Model, _ScalerParams):
    stats = Param("stats", "partition -> (mean, std)", is_complex=True)
    coefficientFactor = Param("coefficientFactor", "", float, 1.0)
    targetMean = Param("targetMean", "", float, 0.0)
    targetStd = Param("targetStd", "", float, 1.0)

    def _transform(self, df: Table) -> Table:
        tm, ts = self.getTargetMean(), self.getTargetStd()
        cf = self.getCoefficientFactor()

        def scale(stat, v):
            mean, std = stat
            return cf * (tm + ts * (v - mean) / (std if std else 1.0))

        return _apply(df, self, self.get("stats"), scale)


class LinearScalarScaler(Estimator, _ScalerParams):
    minRequiredValue = Param("minRequiredValue", "output range min", float, 0.0)
    maxRequiredValue = Param("maxRequiredValue", "output range max", float, 1.0)

    def _fit(self, df: Table) -> "LinearScalarScalerModel":
        stats = _per_partition(df, self, lambda v: (float(v.min()),
                                                    float(v.max())))
        return LinearScalarScalerModel(
            stats=stats, **{p: self.get(p) for p in self._paramMap})


class LinearScalarScalerModel(Model, _ScalerParams):
    stats = Param("stats", "partition -> (min, max)", is_complex=True)
    minRequiredValue = Param("minRequiredValue", "", float, 0.0)
    maxRequiredValue = Param("maxRequiredValue", "", float, 1.0)

    def _transform(self, df: Table) -> Table:
        lo, hi = self.getMinRequiredValue(), self.getMaxRequiredValue()

        def scale(stat, v):
            vmin, vmax = stat
            if vmax == vmin:
                return (lo + hi) / 2.0
            return lo + (hi - lo) * (v - vmin) / (vmax - vmin)

        return _apply(df, self, self.get("stats"), scale)
