"""MultiColumnAdapter — apply a single-column stage across many columns.

Reference: core/.../stages/MultiColumnAdapter.scala (SURVEY.md §2.7): clones a
unary ``baseStage`` once per (inputCol, outputCol) pair and chains them into a
PipelineModel.

The port's copy of the JAX package's ``stages/adapter.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

from ..core.params import Param, HasInputCols, HasOutputCols
from ..core.pipeline import Estimator, Model, PipelineModel
from ..core.table import Table


class MultiColumnAdapter(Estimator, HasInputCols, HasOutputCols):
    baseStage = Param("baseStage", "Base stage to apply to every column", is_complex=True)

    def setBaseStage(self, stage) -> "MultiColumnAdapter":
        return self.set("baseStage", stage)

    def _pairs(self):
        ins, outs = self.getInputCols(), self.getOutputCols()
        if len(ins) != len(outs):
            raise ValueError("inputCols and outputCols must have the same length")
        return list(zip(ins, outs))

    def _fit(self, df: Table) -> Model:
        base = self.get("baseStage")
        fitted = []
        cur = df
        for in_col, out_col in self._pairs():
            stage = base.copy()
            stage.set("inputCol", in_col)
            stage.set("outputCol", out_col)
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
            else:
                model = stage
            cur = model.transform(cur)
            fitted.append(model)
        return PipelineModel(fitted)
