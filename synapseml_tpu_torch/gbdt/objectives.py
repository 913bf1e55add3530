"""Boosting objectives and eval metrics.

Counterpart of the JAX package's ``gbdt/objectives.py``. Ported so far: the
binary log-loss objective (``binary_objective``) and the ``binary_logloss``
and ``auc`` metrics. The other objectives (multiclass, regression family,
lambdarank, ...) are not ported yet; ``get_objective`` rejects them.

Scores are raw margins; ``init_score`` implements boost_from_average.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Objective(NamedTuple):
    name: str
    num_model_per_iteration: int                    # K for multiclass, else 1
    grad_hess: Callable                             # (score, label, weight) -> (g, h)
    init_score: Callable                            # (label, weight) -> 0-d tensor
    transform: Callable                             # raw score -> prediction space


def binary_objective(sigmoid: float = 1.0) -> Objective:
    s = sigmoid

    def gh(score, y, w):
        p = torch.sigmoid(s * score)
        g = s * (p - y)
        h = s * s * p * (1.0 - p)
        return g * w, torch.clamp_min(h * w, 1e-16)

    def init(y, w):
        p = torch.clamp((y * w).sum() / w.sum(), 1e-12, 1 - 1e-12)
        return torch.log(p / (1 - p)) / s

    return Objective("binary", 1, gh, init, lambda sc: torch.sigmoid(s * sc))


def get_objective(name: str, sigmoid: float = 1.0) -> Objective:
    if name != "binary":
        raise NotImplementedError(
            f"objective={name!r} is not ported to the PyTorch package yet "
            "(only 'binary')")
    return binary_objective(sigmoid)


def auc(y_true, y_score, sample_weight=None) -> torch.Tensor:
    """Weighted ROC AUC with exact tie handling: each positive counts the
    negatives scored strictly below it plus HALF the negatives it ties with
    (the trapezoid rule — what LightGBM/sklearn compute)."""
    y_true = torch.as_tensor(y_true, dtype=torch.float32)
    y_score = torch.as_tensor(y_score, dtype=torch.float32, device=y_true.device)
    w = (torch.ones_like(y_true) if sample_weight is None
         else torch.as_tensor(sample_weight, dtype=torch.float32,
                              device=y_true.device))
    order = torch.argsort(y_score, stable=True)
    ys, ws, ss = y_true[order], w[order], y_score[order]
    wneg = torch.where(ys == 0, ws, 0.0)
    cum = torch.cat([torch.zeros(1, device=ys.device), torch.cumsum(wneg, 0)])
    left = torch.searchsorted(ss, ss, side="left")
    right = torch.searchsorted(ss, ss, side="right")
    neg_below = cum[left]
    tie_neg = cum[right] - cum[left]
    auc_sum = torch.where(ys > 0, ws * (neg_below + 0.5 * tie_neg), 0.0).sum()
    pos = torch.where(ys > 0, ws, 0.0).sum()
    neg = wneg.sum()
    return auc_sum / torch.clamp_min(pos * neg, 1e-12)


def binary_logloss(y_true, p, eps=1e-15, weight=None) -> torch.Tensor:
    p = torch.clamp(p, eps, 1 - eps)
    v = -(y_true * torch.log(p) + (1 - y_true) * torch.log1p(-p))
    if weight is None:
        return v.mean()
    return (v * weight).sum() / torch.clamp_min(weight.sum(), 1e-12)


METRICS = {
    "auc": lambda y, pred, **kw: auc(y, pred, kw.get("weight")),
    "binary_logloss": lambda y, pred, **kw: binary_logloss(
        y, pred, weight=kw.get("weight")),
}

HIGHER_IS_BETTER = {"auc"}
