"""KNN / ConditionalKNN estimators.

Reference: nn/KNN.scala:49-127 and nn/ConditionalKNN.scala. ``fit`` indexes the
``featuresCol`` vectors with payloads from ``valuesCol``; ``transform`` answers
max-inner-product queries per row, emitting an output column of
``[{value, distance}, ...]`` (the reference's array-of-struct schema).
ConditionalKNN also reads a per-row ``conditionerCol`` collection and only
returns neighbors whose ``labelCol`` label is in it.

Unlike the reference — which broadcasts the tree and runs a serial UDF per row
— ``transform`` batches all query rows into one product and top-k on the
model's device (the port's counterpart of the JAX package's ``nn/knn.py``).
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

from ..core.device import DEFAULT_DEVICE
from ..core.params import Param, HasFeaturesCol, HasLabelCol, HasOutputCol
from ..core.pipeline import Estimator, Model
from ..core.table import Table
from .balltree import BallTree, ConditionalBallTree


class _KNNParams(HasFeaturesCol, HasOutputCol):
    valuesCol = Param("valuesCol",
                      "column holding values for each feature (key) that will "
                      "be returned when queried", str, "values")
    leafSize = Param("leafSize", "max size of the leaves of the ball index", int, 50)
    k = Param("k", "number of matches to return", int, 5)
    device = Param("device", "Device that holds the keys and answers the "
                   "queries: 'cuda' (default) or 'cpu'", str, DEFAULT_DEVICE)


def _features_matrix(df: Table, col: str) -> np.ndarray:
    arr = df[col]
    if arr.dtype == object:
        arr = np.stack([np.asarray(v, dtype=np.float32) for v in arr])
    return np.asarray(arr, dtype=np.float32)


class KNN(Estimator, _KNNParams):
    """Fit a max-inner-product index over the dataset (reference KNN.scala:49-77)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if not self.isSet("outputCol"):
            self.setOutputCol(self.uid + "_output")

    def _fit(self, df: Table) -> "KNNModel":
        keys = _features_matrix(df, self.getFeaturesCol())
        values = list(df[self.getValuesCol()]) if self.getValuesCol() in df \
            else list(range(keys.shape[0]))
        tree = BallTree(keys, values, leaf_size=self.getLeafSize(),
                        device=self.getDevice())
        return KNNModel(ballTree=tree, **{p: self.get(p) for p in self._paramMap})


class KNNModel(Model, _KNNParams):
    ballTree = Param("ballTree", "the ball index used for performing queries",
                     is_complex=True)

    def setBallTree(self, v: BallTree) -> "KNNModel":
        return self.set("ballTree", v)

    def getBallTree(self) -> BallTree:
        return self.get("ballTree")

    def _transform(self, df: Table) -> Table:
        tree: BallTree = self.getBallTree().to(self.getDevice())
        q = _features_matrix(df, self.getFeaturesCol())
        idx, scores = tree.query_batch(q, self.getK())
        out = np.empty(len(idx), dtype=object)
        for r in range(len(idx)):
            out[r] = [{"value": tree.values[i], "distance": float(s)}
                      for i, s in zip(idx[r], scores[r])]
        return df.with_column(self.getOutputCol(), out)


class _ConditionalKNNParams(_KNNParams, HasLabelCol):
    conditionerCol = Param(
        "conditionerCol",
        "column holding identifiers for features that will be returned when "
        "queried", str, "conditioner")


class ConditionalKNN(Estimator, _ConditionalKNNParams):
    """KNN whose index carries labels; queries filter by per-row label sets
    (reference ConditionalKNN.scala:32-60)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if not self.isSet("outputCol"):
            self.setOutputCol(self.uid + "_output")
        if not self.isSet("labelCol"):
            self.setLabelCol("labels")

    def _fit(self, df: Table) -> "ConditionalKNNModel":
        keys = _features_matrix(df, self.getFeaturesCol())
        values = list(df[self.getValuesCol()]) if self.getValuesCol() in df \
            else list(range(keys.shape[0]))
        labels = list(df[self.getLabelCol()])
        tree = ConditionalBallTree(keys, labels, values,
                                   leaf_size=self.getLeafSize(),
                                   device=self.getDevice())
        return ConditionalKNNModel(
            ballTree=tree, **{p: self.get(p) for p in self._paramMap})


class ConditionalKNNModel(Model, _ConditionalKNNParams):
    ballTree = Param("ballTree", "the conditional ball index used for queries",
                     is_complex=True)

    def setBallTree(self, v: ConditionalBallTree) -> "ConditionalKNNModel":
        return self.set("ballTree", v)

    def getBallTree(self) -> ConditionalBallTree:
        return self.get("ballTree")

    def _transform(self, df: Table) -> Table:
        tree: ConditionalBallTree = self.getBallTree().to(self.getDevice())
        q = _features_matrix(df, self.getFeaturesCol())
        conds: List[Any] = [c if isinstance(c, (list, tuple, set, np.ndarray))
                            else [c] for c in df[self.getConditionerCol()]]
        idx, scores = tree.query_batch_conditional(q, conds, self.getK())
        out = np.empty(len(idx), dtype=object)
        for r in range(len(idx)):
            keep = np.isfinite(scores[r])
            out[r] = [{"value": tree.values[i], "distance": float(s)}
                      for i, s in zip(idx[r][keep], scores[r][keep])]
        return df.with_column(self.getOutputCol(), out)
