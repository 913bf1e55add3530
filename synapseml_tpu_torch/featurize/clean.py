"""CleanMissingData: impute NaNs per column (reference:
core/.../featurize/CleanMissingData.scala — Mean/Median/Custom modes).

The port's copy of the JAX package's ``featurize/clean.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations


import numpy as np

from ..core.params import Param, HasInputCols, HasOutputCols
from ..core.pipeline import Estimator, Model
from ..core.table import Table


class CleanMissingData(Estimator, HasInputCols, HasOutputCols):
    cleaningMode = Param("cleaningMode", "Mean | Median | Custom", str, "Mean")
    customValue = Param("customValue", "Fill value for Custom mode", float)

    def _fit(self, df: Table) -> "CleanMissingDataModel":
        cols = list(self.inputCols or df.columns)
        fills = []
        for c in cols:
            a = np.asarray(df[c], np.float64)
            finite = a[np.isfinite(a)]
            if self.cleaningMode == "Custom":
                fills.append(float(self.customValue))
            elif self.cleaningMode == "Median":
                fills.append(float(np.median(finite)) if len(finite) else 0.0)
            else:
                fills.append(float(finite.mean()) if len(finite) else 0.0)
        return CleanMissingDataModel(
            inputCols=cols, outputCols=list(self.outputCols or cols), fillValues=fills)


class CleanMissingDataModel(Model, HasInputCols, HasOutputCols):
    fillValues = Param("fillValues", "Per-column fill values", list)

    def _transform(self, df: Table) -> Table:
        out = df.copy()
        for c, o, v in zip(self.inputCols, self.outputCols, self.fillValues):
            a = np.asarray(df[c], np.float64)
            out[o] = np.where(np.isfinite(a), a, v).astype(np.float32)
        return out
