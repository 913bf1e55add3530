"""Evaluation metrics (reference: core/.../core/metrics/MetricConstants.scala +
train/ComputeModelStatistics.scala metric math). Vectorized host NumPy (float64) — AUC via
rank statistic, NDCG for ranking parity.

The port's copy of the JAX package's ``train/metrics.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class MetricConstants:
    AucSparkMetric = "AUC"
    AccuracySparkMetric = "accuracy"
    PrecisionSparkMetric = "precision"
    RecallSparkMetric = "recall"
    F1Metric = "f1"
    MseSparkMetric = "mse"
    RmseSparkMetric = "rmse"
    MaeSparkMetric = "mae"
    R2SparkMetric = "R^2"
    AllSparkMetrics = "all"
    ClassificationMetricsName = "classification"
    RegressionMetricsName = "regression"


def auc_score(y_true: np.ndarray, score: np.ndarray) -> float:
    """ROC AUC by the Mann-Whitney rank statistic (ties averaged)."""
    y = np.asarray(y_true, np.float64)
    s = np.asarray(score, np.float64)
    pos = y > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), np.float64)
    sorted_s = s[order]
    # average ranks over ties
    _, inv, counts = np.unique(sorted_s, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    avg = (cum - (counts - 1) / 2.0)
    ranks[order] = avg[inv]
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def binary_classification_metrics(y_true, y_pred, score=None) -> Dict[str, float]:
    y = np.asarray(y_true, np.float64)
    p = np.asarray(y_pred, np.float64)
    tp = float(((p > 0) & (y > 0)).sum())
    fp = float(((p > 0) & (y <= 0)).sum())
    fn = float(((p <= 0) & (y > 0)).sum())
    tn = float(((p <= 0) & (y <= 0)).sum())
    prec = tp / (tp + fp) if tp + fp > 0 else 0.0
    rec = tp / (tp + fn) if tp + fn > 0 else 0.0
    out = {
        "accuracy": (tp + tn) / max(len(y), 1),
        "precision": prec,
        "recall": rec,
        "f1": 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0,
        "confusion_matrix": np.array([[tn, fp], [fn, tp]]),
    }
    if score is not None:
        out["AUC"] = auc_score(y, score)
    return out


def multiclass_metrics(y_true, y_pred) -> Dict[str, float]:
    y = np.asarray(y_true)
    p = np.asarray(y_pred)
    classes = np.unique(np.concatenate([y, p]))
    k = len(classes)
    lut = {c: i for i, c in enumerate(classes)}
    cm = np.zeros((k, k), np.float64)
    for a, b in zip(y, p):
        cm[lut[a], lut[b]] += 1
    diag = np.diag(cm)
    prec = np.where(cm.sum(0) > 0, diag / np.maximum(cm.sum(0), 1), 0.0)
    rec = np.where(cm.sum(1) > 0, diag / np.maximum(cm.sum(1), 1), 0.0)
    return {"accuracy": float(diag.sum() / max(cm.sum(), 1)),
            "macro_precision": float(prec.mean()),
            "macro_recall": float(rec.mean()),
            "confusion_matrix": cm}


def regression_metrics(y_true, y_pred) -> Dict[str, float]:
    y = np.asarray(y_true, np.float64)
    p = np.asarray(y_pred, np.float64)
    err = p - y
    mse = float((err ** 2).mean()) if len(y) else float("nan")
    ss_tot = float(((y - y.mean()) ** 2).sum()) if len(y) else 0.0
    return {"mse": mse, "rmse": float(np.sqrt(mse)), "mae": float(np.abs(err).mean()),
            "R^2": 1.0 - (err ** 2).sum() / ss_tot if ss_tot > 0 else float("nan")}


def ranking_ndcg(y_true, score, groups, k: Optional[int] = None) -> float:
    """Mean NDCG@k over query groups (LightGBMRanker eval parity)."""
    y = np.asarray(y_true, np.float64)
    s = np.asarray(score, np.float64)
    g = np.asarray(groups)
    vals = []
    for q in np.unique(g):
        m = g == q
        yy, ss = y[m], s[m]
        kk = len(yy) if k is None else min(k, len(yy))
        order = np.argsort(-ss)[:kk]
        gains = (2.0 ** yy[order] - 1) / np.log2(np.arange(2, kk + 2))
        ideal = np.sort(yy)[::-1][:kk]
        igains = (2.0 ** ideal - 1) / np.log2(np.arange(2, kk + 2))
        vals.append(gains.sum() / igains.sum() if igains.sum() > 0 else 0.0)
    return float(np.mean(vals)) if vals else float("nan")
