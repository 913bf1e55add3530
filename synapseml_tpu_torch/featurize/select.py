"""CountSelector: drop all-zero feature slots (reference:
core/.../featurize/CountSelector.scala — CountBasedFeatureSelector).

The port's copy of the JAX package's ``featurize/select.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import numpy as np

from ..core.params import Param, HasInputCol, HasOutputCol
from ..core.pipeline import Estimator, Model
from ..core.table import Table


class CountSelector(Estimator, HasInputCol, HasOutputCol):
    def __init__(self, **kwargs):
        kwargs.setdefault("inputCol", "features")
        kwargs.setdefault("outputCol", "features")
        super().__init__(**kwargs)

    def _fit(self, df: Table) -> "CountSelectorModel":
        X = np.asarray(df[self.inputCol], np.float64)
        keep = np.nonzero((X != 0).any(axis=0))[0]
        return CountSelectorModel(inputCol=self.inputCol, outputCol=self.outputCol,
                                  indices=[int(i) for i in keep])


class CountSelectorModel(Model, HasInputCol, HasOutputCol):
    indices = Param("indices", "Kept feature-slot indices", list)

    def _transform(self, df: Table) -> Table:
        X = np.asarray(df[self.inputCol], np.float32)
        return df.with_column(self.outputCol, X[:, np.asarray(self.indices, np.int64)])
