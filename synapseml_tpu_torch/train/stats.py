"""ComputeModelStatistics / ComputePerInstanceStatistics.

Reference: core/.../train/ComputeModelStatistics.scala (scored DataFrame →
one-row metrics table; evaluationMetric selects classification vs regression)
and ComputePerInstanceStatistics.scala (per-row loss columns).

The port's copy of the JAX package's ``train/stats.py`` (host code; the port
imports nothing of that package).
"""

from __future__ import annotations

import numpy as np

from ..core.params import Param, HasLabelCol, HasPredictionCol
from ..core.pipeline import Transformer
from ..core.table import Table
from .metrics import (binary_classification_metrics, multiclass_metrics,
                      regression_metrics)


class ComputeModelStatistics(Transformer, HasLabelCol, HasPredictionCol):
    evaluationMetric = Param("evaluationMetric",
                             "classification | regression | all", str, "all")
    scoresCol = Param("scoresCol", "Raw score / probability column for AUC", str)

    def _transform(self, df: Table) -> Table:
        y = np.asarray(df[self.labelCol], np.float64)
        pred = np.asarray(df[self.predictionCol], np.float64)
        metric = self.evaluationMetric
        is_classification = metric == "classification" or (
            metric == "all" and len(np.unique(y)) <= max(2, min(20, len(y) // 2))
            and np.allclose(y, np.round(y)))
        if is_classification:
            score = None
            sc = self.get("scoresCol")
            if sc and sc in df:
                s = df[sc]
                score = s[:, -1] if s.ndim == 2 else np.asarray(s, np.float64)
            if len(np.unique(y)) <= 2:
                m = binary_classification_metrics(y, pred, score)
            else:
                m = multiclass_metrics(y, pred)
            cm = m.pop("confusion_matrix")
            row = {k: np.array([v]) for k, v in m.items()}
            row["confusion_matrix"] = np.array([cm])
            return Table(row)
        m = regression_metrics(y, pred)
        return Table({k: np.array([v]) for k, v in m.items()})


class ComputePerInstanceStatistics(Transformer, HasLabelCol, HasPredictionCol):
    probabilityCol = Param("probabilityCol", "Probability column (classification)", str,
                           "probability")
    evaluationMetric = Param("evaluationMetric", "classification | regression | all",
                             str, "all")

    def _transform(self, df: Table) -> Table:
        y = np.asarray(df[self.labelCol], np.float64)
        pred = np.asarray(df[self.predictionCol], np.float64)
        out = df.copy()
        pc = self.get("probabilityCol")
        if pc and pc in df and self.evaluationMetric != "regression":
            prob = df[pc]
            if prob.ndim == 2:
                idx = np.clip(y.astype(np.int64), 0, prob.shape[1] - 1)
                p_true = prob[np.arange(len(y)), idx]
            else:
                p_true = np.where(y > 0, prob, 1.0 - prob)
            out["log_loss"] = -np.log(np.maximum(p_true, 1e-15))
        else:
            out["L1_loss"] = np.abs(pred - y)
            out["L2_loss"] = (pred - y) ** 2
        return out
