"""Orthogonal-forest DML: heterogeneous (per-row) treatment effects.

Reference: causal/OrthoForestDMLEstimator.scala + OrthoForestVariableTransformer
.scala — residualize outcome and treatment with cross-fitted nuisance models,
then grow a forest over the heterogeneity features to localize the effect.
Here the final stage is the R-learner reformulation: minimizing
``Σ (ỹᵢ − θ(xᵢ) t̃ᵢ)²`` over trees equals a weighted regression of the
pseudo-outcome ``ỹ/t̃`` with weights ``t̃²`` — which the port's own
histogram-GBDT engine fits directly on the estimator's ``device`` (no
bespoke forest code).
"""

from __future__ import annotations

import numpy as np

from ..core.device import DEFAULT_DEVICE
from ..core.params import Param
from ..core.pipeline import Model
from ..core.table import Table
from .doubleml import DoubleMLEstimator, _DoubleMLParams, _predict_col, _retarget


class _OrthoForestParams(_DoubleMLParams):
    heterogeneityCol = Param("heterogeneityCol",
                             "features X over which effects vary", str,
                             "heterogeneityFeatures")
    outputCol = Param("outputCol", "per-row effect column", str, "EffectAverage")
    numTrees = Param("numTrees", "trees in the effect forest", int, 60)
    maxDepth = Param("maxDepth", "max depth of effect trees", int, 5)
    minSamplesLeaf = Param("minSamplesLeaf", "min rows per leaf", int, 10)
    device = Param("device", "Device of the effect forest: 'cuda' "
                   "(default) or 'cpu'", str, DEFAULT_DEVICE)


class OrthoForestDMLEstimator(DoubleMLEstimator, _OrthoForestParams):
    def _fit(self, df: Table) -> "OrthoForestDMLModel":
        for p in ("treatmentModel", "outcomeModel"):
            if self.get(p) is None:
                raise ValueError(f"OrthoForestDMLEstimator: {p} is not set")
        rng = np.random.default_rng(self.getSeed())
        n = df.num_rows
        perm = rng.permutation(n)
        half = n // 2
        y_res = np.zeros(n)
        t_res = np.zeros(n)
        for train_idx, test_idx in ((perm[:half], perm[half:]),
                                    (perm[half:], perm[:half])):
            train, test = df.take(train_idx), df.take(test_idx)
            tm, om = self.get("treatmentModel").copy(), self.get("outcomeModel").copy()
            _retarget(tm, self.getFeaturesCol(), self.getTreatmentCol())
            _retarget(om, self.getFeaturesCol(), self.getOutcomeCol())
            t_res[test_idx] = (np.asarray(test[self.getTreatmentCol()], np.float64)
                               - _predict_col(tm.fit(train), test))
            y_res[test_idx] = (np.asarray(test[self.getOutcomeCol()], np.float64)
                               - _predict_col(om.fit(train), test))

        # R-learner final stage on the heterogeneity features
        t_res = np.where(np.abs(t_res) < 1e-6, np.sign(t_res + 1e-12) * 1e-6, t_res)
        pseudo = y_res / t_res
        weights = t_res ** 2
        from ..models import LightGBMRegressor

        forest = LightGBMRegressor(
            numIterations=self.getNumTrees(), maxDepth=self.getMaxDepth(),
            minDataInLeaf=self.getMinSamplesLeaf(),
            featuresCol=self.getHeterogeneityCol(), labelCol="__pseudo",
            weightCol="__w", device=self.getDevice())
        work = df.copy()
        work["__pseudo"] = pseudo
        work["__w"] = weights
        effect_model = forest.fit(work)
        return OrthoForestDMLModel(effectModel=effect_model,
                                   **{p: self.get(p) for p in self._paramMap})


class OrthoForestDMLModel(Model, _OrthoForestParams):
    effectModel = Param("effectModel", "fitted effect forest", is_complex=True)

    def _transform(self, df: Table) -> Table:
        scored = self.get("effectModel").transform(df)
        pred_col = self.get("effectModel").get("predictionCol") or "prediction"
        return df.with_column(self.getOutputCol(), scored[pred_col])
