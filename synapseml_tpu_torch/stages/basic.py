"""Column plumbing and function-application stages.

Reference: core/.../stages/{UDFTransformer,Lambda,Cacher,Timer,Repartition,
Explode,DropColumns,SelectColumns,RenameColumn}.scala (SURVEY.md §2.7).

The port's copy of the JAX package's ``stages/basic.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from ..core.logging import logger as _logger
from ..core.params import Param, HasInputCol, HasInputCols, HasOutputCol
from ..core.pipeline import PipelineStage, Transformer
from ..core.table import Table


class UDFTransformer(Transformer, HasInputCol, HasInputCols, HasOutputCol):
    """Apply a user function to one or more columns.

    Reference: stages/UDFTransformer.scala. The function receives the input
    column array(s) (whole-column, vectorized — not per-row as in Spark) and
    must return an array of the same length. Set ``vectorized=False`` to wrap a
    per-row scalar function instead.
    """

    udf = Param("udf", "User defined function: column array(s) -> column array",
                is_complex=True)
    vectorized = Param("vectorized", "Whether udf operates on whole columns", bool, True)

    def setUDF(self, f: Callable) -> "UDFTransformer":
        return self.set("udf", f)

    def _transform(self, df: Table) -> Table:
        f = self.get("udf")
        if f is None:
            raise ValueError("UDFTransformer: udf is not set")
        if self.isSet("inputCols"):
            args = [df[c] for c in self.getInputCols()]
        else:
            args = [df[self.getInputCol()]]
        if self.getVectorized():
            out = f(*args)
        else:
            out = np.asarray([f(*vals) for vals in zip(*args)])
        return df.with_column(self.getOutputCol(), np.asarray(out))


class Lambda(Transformer):
    """Arbitrary Table → Table function stage.

    Reference: stages/Lambda.scala (transformFunc + optional transformSchemaFunc).
    """

    transformFunc = Param("transformFunc", "Table -> Table function", is_complex=True)

    def setTransform(self, f: Callable[[Table], Table]) -> "Lambda":
        return self.set("transformFunc", f)

    def _transform(self, df: Table) -> Table:
        f = self.get("transformFunc")
        if f is None:
            raise ValueError("Lambda: transformFunc is not set")
        out = f(df)
        return out if isinstance(out, Table) else Table(out)


class Cacher(Transformer):
    """Materialize the table (device arrays → host, lazy chains → concrete).

    Reference: stages/Cacher.scala (df.cache()). Columnar Tables are already
    materialized numpy; this forces any lazily-wrapped columns to concrete
    arrays and optionally keeps a reference so repeated upstream recompute is
    avoided when used inside Pipelines.
    """

    disable = Param("disable", "Whether or disable the cacher", bool, False)

    def _transform(self, df: Table) -> Table:
        if self.getDisable():
            return df
        out = Table({k: np.asarray(df[k]) for k in df.columns})
        self._cached = out
        return out


class Timer(Transformer):
    """Time a wrapped stage's fit/transform and record it.

    Reference: stages/Timer.scala (logs to stdout / returns time in a column).
    """

    stage = Param("stage", "The stage to time", is_complex=True)
    logToScala = Param("logToScala", "Whether to output the time to the log", bool, True)
    disableMaterialization = Param(
        "disableMaterialization", "Whether to disable timing (so that one can turn it off for evaluation)",
        bool, True)

    def setStage(self, stage: PipelineStage) -> "Timer":
        return self.set("stage", stage)

    def fit(self, df: Table, params=None):
        inner = self.get("stage")
        t0 = time.perf_counter()
        model = inner.fit(df)
        self.elapsed_fit_s = time.perf_counter() - t0
        if self.getLogToScala():
            _logger.info("Timer[%s].fit took %.4fs", type(inner).__name__, self.elapsed_fit_s)
        out = Timer(logToScala=self.getLogToScala())
        out.set("stage", model)
        return out

    def _transform(self, df: Table) -> Table:
        inner = self.get("stage")
        t0 = time.perf_counter()
        out = inner.transform(df)
        self.elapsed_transform_s = time.perf_counter() - t0
        if self.getLogToScala():
            _logger.info("Timer[%s].transform took %.4fs",
                         type(inner).__name__, self.elapsed_transform_s)
        return out


class Repartition(Transformer):
    """Record a target shard count for downstream SPMD execution.

    Reference: stages/Repartition.scala (df.repartition(n) / coalesce). A Table
    is one host-resident block; sharding happens when an estimator lays data on
    the mesh, so this stage attaches the intended shard count as a hint column
    metadata (``table.shard(n)`` consumes it) and optionally reorders rows
    round-robin so contiguous shards are balanced.
    """

    n = Param("n", "Number of partitions", int, 1)
    disable = Param("disable", "Whether to disable repartitioning (so that one can turn it off for evaluation)",
                    bool, False)

    def _transform(self, df: Table) -> Table:
        if self.getDisable():
            return df
        n = self.getN()
        out = df.copy()
        out.num_shards_hint = n
        return out


class Explode(Transformer, HasInputCol, HasOutputCol):
    """One output row per element of a list column, other columns repeated.

    Reference: stages/Explode.scala.
    """

    def _transform(self, df: Table) -> Table:
        col = df[self.getInputCol()]
        out_name = self.getOutputCol() if self.isSet("outputCol") else self.getInputCol()
        lengths = np.asarray([len(np.atleast_1d(v)) for v in col])
        rep_idx = np.repeat(np.arange(df.num_rows), lengths)
        out = Table()
        for name in df.columns:
            if name == self.getInputCol():
                continue
            out[name] = df[name][rep_idx]
        out[out_name] = np.concatenate([np.atleast_1d(v) for v in col]) if len(col) else np.array([])
        return out


class DropColumns(Transformer):
    """Reference: stages/DropColumns.scala."""

    cols = Param("cols", "Comma separated list of column names", list)

    def setCols(self, cols) -> "DropColumns":
        return self.set("cols", list(cols))

    def _transform(self, df: Table) -> Table:
        return df.drop(*self.getCols())


class SelectColumns(Transformer):
    """Reference: stages/SelectColumns.scala."""

    cols = Param("cols", "Comma separated list of selected column names", list)

    def setCols(self, cols) -> "SelectColumns":
        return self.set("cols", list(cols))

    def _transform(self, df: Table) -> Table:
        return df.select(self.getCols())


class RenameColumn(Transformer, HasInputCol, HasOutputCol):
    """Reference: stages/RenameColumn.scala."""

    def _transform(self, df: Table) -> Table:
        return df.rename({self.getInputCol(): self.getOutputCol()})
