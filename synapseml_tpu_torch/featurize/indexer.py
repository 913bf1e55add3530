"""ValueIndexer / IndexToValue (reference: core/.../featurize/ValueIndexer.scala,
IndexToValue.scala — categorical value <-> index with metadata).

The port's copy of the JAX package's ``featurize/indexer.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import numpy as np

from ..core.params import Param, HasInputCol, HasOutputCol
from ..core.pipeline import Estimator, Model, Transformer
from ..core.table import Table


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    """Learn value→index mapping (sorted distinct values; index 0..K-1)."""

    def _fit(self, df: Table) -> "ValueIndexerModel":
        vals = np.unique(np.asarray(df[self.inputCol]))
        return ValueIndexerModel(inputCol=self.inputCol,
                                 outputCol=self.outputCol,
                                 levels=[v.item() if hasattr(v, "item") else v for v in vals])


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    levels = Param("levels", "Ordered distinct values; index = position", list)
    unknownIndex = Param("unknownIndex", "Index for unseen values (-1 default)", int, -1)

    def _transform(self, df: Table) -> Table:
        lut = {v: i for i, v in enumerate(self.levels)}
        a = df[self.inputCol]
        out = np.fromiter((lut.get(v.item() if hasattr(v, "item") else v,
                                   self.unknownIndex) for v in a),
                          dtype=np.int64, count=len(a))
        return df.with_column(self.outputCol, out)


class IndexToValue(Transformer, HasInputCol, HasOutputCol):
    """Inverse mapping using a ValueIndexerModel's levels."""
    levels = Param("levels", "Ordered distinct values", list)

    def _transform(self, df: Table) -> Table:
        levels = self.levels
        idx = np.asarray(df[self.inputCol], np.int64)
        vals = np.array([levels[i] if 0 <= i < len(levels) else None for i in idx],
                        dtype=object)
        return df.with_column(self.outputCol, vals)
