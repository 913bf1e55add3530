"""Double machine learning (DML) for average treatment effects.

Reference: causal/DoubleMLEstimator.scala:63-307 + DoubleMLParams.scala.
Semantics kept: nuisance models f(X)≈E[T|X] and q(X)≈E[Y|X] are fit with
2-fold cross-fitting (each half predicts the other — trainInternal:196-252);
the ATE is the slope of outcome residuals on treatment residuals; the whole
procedure repeats ``maxIter`` times over fresh random splits and the model
stores every raw ATE, reporting the median as the effect and a percentile
bootstrap confidence interval (confidenceLevel).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.params import Param, HasFeaturesCol
from ..core.pipeline import Estimator, Model
from ..core.table import Table
from .solvers import linear_regression_with_se


class _DoubleMLParams(HasFeaturesCol):
    treatmentModel = Param("treatmentModel", "treatment nuisance estimator "
                           "(learns E[T|X])", is_complex=True)
    outcomeModel = Param("outcomeModel", "outcome nuisance estimator "
                         "(learns E[Y|X])", is_complex=True)
    treatmentCol = Param("treatmentCol", "treatment column", str, "treatment")
    outcomeCol = Param("outcomeCol", "outcome column", str, "outcome")
    sampleSplitRatio = Param("sampleSplitRatio",
                             "train/test split ratio for cross-fitting",
                             list, [0.5, 0.5])
    confidenceLevel = Param("confidenceLevel", "CI level", float, 0.975)
    maxIter = Param("maxIter", "number of random-split repetitions "
                    "(CI bootstrap iterations)", int, 1)
    parallelism = Param("parallelism", "concurrent split fits", int, 10)
    seed = Param("seed", "random seed", int, 0)


def _predict_col(model, df: Table) -> np.ndarray:
    """Nuisance prediction: probability of class 1 for classifiers, prediction
    otherwise (reference getPredictedCols: probability → vector_to_double)."""
    out = model.transform(df)
    for cand in ("probability", model.get("probabilityCol")
                 if model.hasParam("probabilityCol") else None,
                 "prediction", model.get("predictionCol")
                 if model.hasParam("predictionCol") else None):
        if cand and cand in out:
            col = out[cand]
            if col.ndim == 2:  # class-probability vector -> P(T=1)
                return np.asarray(col[:, -1], dtype=np.float64)
            return np.asarray(col, dtype=np.float64)
    raise ValueError(f"nuisance model {type(model).__name__} produced no "
                     "probability/prediction column")


class DoubleMLEstimator(Estimator, _DoubleMLParams):
    def _fit(self, df: Table) -> "DoubleMLModel":
        for p in ("treatmentModel", "outcomeModel"):
            if self.get(p) is None:
                raise ValueError(f"DoubleMLEstimator: {p} is not set")
        rng = np.random.default_rng(self.getSeed())
        ates: List[float] = []
        for _ in range(self.getMaxIter()):
            ate = self._one_split(df, rng)
            if ate is not None:
                ates.append(ate)
        if not ates:
            raise RuntimeError("Failed to calculate the ATE on any split — "
                               "check nuisance models and data")
        return DoubleMLModel(rawTreatmentEffects=ates,
                             **{p: self.get(p) for p in self._paramMap})

    def _one_split(self, df: Table, rng) -> Optional[float]:
        n = df.num_rows
        ratio = self.get("sampleSplitRatio")
        perm = rng.permutation(n)
        cut = int(round(n * ratio[0] / (ratio[0] + ratio[1])))
        a, b = perm[:cut], perm[cut:]
        if a.size < 2 or b.size < 2:
            return None
        # cross-fitting: fit on a predict b, fit on b predict a
        res = []
        for train_idx, test_idx in ((a, b), (b, a)):
            train, test = df.take(train_idx), df.take(test_idx)
            tm = self.get("treatmentModel").copy()
            om = self.get("outcomeModel").copy()
            _retarget(tm, self.getFeaturesCol(), self.getTreatmentCol())
            _retarget(om, self.getFeaturesCol(), self.getOutcomeCol())
            t_hat = _predict_col(tm.fit(train), test)
            y_hat = _predict_col(om.fit(train), test)
            t_res = np.asarray(test[self.getTreatmentCol()], np.float64) - t_hat
            y_res = np.asarray(test[self.getOutcomeCol()], np.float64) - y_hat
            res.append((y_res, t_res))
        # final stage: slope of y_res on t_res per fold, averaged
        # (reference: regression per residual DF, coefficients averaged :251-263)
        coefs = []
        for y_res, t_res in res:
            if np.allclose(t_res.var(), 0):
                return None
            beta, _ = linear_regression_with_se(t_res[:, None], y_res,
                                                fit_intercept=False)
            coefs.append(beta[0])
        return float(np.mean(coefs))


def _retarget(est, features_col: str, label_col: str) -> None:
    if est.hasParam("featuresCol"):
        est.set("featuresCol", features_col)
    if est.hasParam("labelCol"):
        est.set("labelCol", label_col)


class DoubleMLModel(Model, _DoubleMLParams):
    rawTreatmentEffects = Param("rawTreatmentEffects",
                                "ATE per random split", is_complex=True)

    def get_avg_treatment_effect(self) -> float:
        """Median of the per-split ATEs (robust aggregate)."""
        return float(np.median(self.get("rawTreatmentEffects")))

    def get_confidence_interval(self) -> List[float]:
        effects = np.asarray(self.get("rawTreatmentEffects"))
        if effects.size < 2:
            raise ValueError(
                "confidence intervals need maxIter > 1 raw effects")
        alpha = 1.0 - self.getConfidenceLevel()
        lo, hi = np.quantile(effects, [alpha, 1.0 - alpha])
        return [float(lo), float(hi)]

    def get_pvalue(self) -> float:
        """Two-sided p-value from the bootstrap distribution's sign split."""
        effects = np.asarray(self.get("rawTreatmentEffects"))
        frac = min((effects > 0).mean(), (effects < 0).mean())
        return float(min(1.0, 2.0 * frac + 1.0 / max(effects.size, 1)))

    getAvgTreatmentEffect = get_avg_treatment_effect
    getConfidenceInterval = get_confidence_interval
    getPValue = get_pvalue

    def _transform(self, df: Table) -> Table:
        return df.with_column(
            "EffectAverage",
            np.full(df.num_rows, self.get_avg_treatment_effect()))
