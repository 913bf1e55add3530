"""ResidualTransformer — observed − predicted column.

Reference: causal/ResidualTransformer.scala (computes outcome residuals from a
prediction column, handling probability vectors by taking P(class=1)).
"""

from __future__ import annotations

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.table import Table


class ResidualTransformer(Transformer):
    observedCol = Param("observedCol", "observed value column", str, "label")
    predictedCol = Param("predictedCol", "predicted value column", str,
                         "prediction")
    outputCol = Param("outputCol", "residual column", str, "residual")
    classIndex = Param("classIndex", "class index when predictedCol is a "
                       "probability vector", int, 1)

    def _transform(self, df: Table) -> Table:
        obs = np.asarray(df[self.getObservedCol()], np.float64)
        pred = df[self.getPredictedCol()]
        if pred.ndim == 2:
            pred = pred[:, self.getClassIndex()]
        return df.with_column(self.getOutputCol(),
                              obs - np.asarray(pred, np.float64))
