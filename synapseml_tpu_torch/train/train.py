"""TrainClassifier / TrainRegressor.

Reference: core/.../train/{TrainClassifier,TrainRegressor}.scala — wrap any
estimator: auto-featurize raw columns (Featurize), index labels, fit, and
return a model that both featurizes and scores at transform time.

The port's copy of the JAX package's ``train/train.py`` (host code; the port
imports nothing of that package).
"""

from __future__ import annotations


import numpy as np

from ..core.params import Param, HasFeaturesCol, HasLabelCol
from ..core.pipeline import Estimator, Model
from ..core.table import Table
from ..featurize import Featurize, ValueIndexer


class _TrainBase(Estimator, HasLabelCol, HasFeaturesCol):
    model = Param("model", "Underlying estimator to train", object)
    numFeatures = Param("numFeatures", "Hash dimension for string columns", int, 256)

    def _featurizer(self, df: Table):
        cols = [c for c in df.columns if c not in (self.labelCol, self.featuresCol)]
        feat = Featurize(inputCols=cols, outputCol=self.featuresCol,
                         numFeatures=self.numFeatures)
        return feat.fit(df) if self.featuresCol not in df else None


class TrainClassifier(_TrainBase):
    """Auto-featurize + index labels + fit a classifier (TrainClassifier.scala)."""

    def _fit(self, df: Table) -> "TrainedClassifierModel":
        fz = self._featurizer(df)
        work = fz.transform(df) if fz is not None else df
        indexer = ValueIndexer(inputCol=self.labelCol,
                               outputCol="__label_indexed").fit(work)
        work = indexer.transform(work)
        if self.model is None:
            from ..models import LightGBMClassifier
            est = LightGBMClassifier()
        else:
            est = self.model.copy()  # never mutate the caller's estimator
        est.set("labelCol", "__label_indexed")
        est.set("featuresCol", self.featuresCol)
        fitted = est.fit(work)
        return TrainedClassifierModel(featurizer=fz, indexer=indexer, innerModel=fitted,
                                      labelCol=self.labelCol, featuresCol=self.featuresCol)


class TrainRegressor(_TrainBase):
    """Auto-featurize + fit a regressor (TrainRegressor.scala)."""

    def _fit(self, df: Table) -> "TrainedRegressorModel":
        fz = self._featurizer(df)
        work = fz.transform(df) if fz is not None else df
        if self.model is None:
            from ..models import LightGBMRegressor
            est = LightGBMRegressor()
        else:
            est = self.model.copy()  # never mutate the caller's estimator
        est.set("labelCol", self.labelCol)
        est.set("featuresCol", self.featuresCol)
        fitted = est.fit(work)
        return TrainedRegressorModel(featurizer=fz, innerModel=fitted,
                                     labelCol=self.labelCol, featuresCol=self.featuresCol)


class _TrainedBase(Model, HasLabelCol, HasFeaturesCol):
    featurizer = Param("featurizer", "Fitted Featurize model (None if pre-featurized)",
                       object)
    innerModel = Param("innerModel", "Fitted underlying model", object)

    def _apply_featurizer(self, df: Table) -> Table:
        fz = self.get("featurizer")
        return fz.transform(df) if fz is not None else df

    def _save_extra(self, path: str) -> None:
        import os
        for name in ("featurizer", "innerModel", "indexer"):
            m = self.get(name)
            if m is not None:
                m.save(os.path.join(path, name))

    def _load_extra(self, path: str) -> None:
        import os
        from ..core.pipeline import PipelineStage
        for name in ("featurizer", "innerModel", "indexer"):
            p = os.path.join(path, name)
            if os.path.isdir(p):
                self.set(name, PipelineStage.load(p, self._load_device))


class TrainedClassifierModel(_TrainedBase):
    indexer = Param("indexer", "Fitted label ValueIndexerModel", object)

    def _transform(self, df: Table) -> Table:
        out = self.innerModel.transform(self._apply_featurizer(df))
        # map indexed predictions back to original label values
        idxr = self.get("indexer")
        if idxr is not None and "prediction" in out:
            levels = idxr.levels
            pred = np.asarray(out["prediction"], np.int64)
            vals = np.array([levels[i] if 0 <= i < len(levels) else None for i in pred])
            out = out.with_column("scored_labels", vals)
        return out


class TrainedRegressorModel(_TrainedBase):
    def _transform(self, df: Table) -> Table:
        return self.innerModel.transform(self._apply_featurizer(df))
