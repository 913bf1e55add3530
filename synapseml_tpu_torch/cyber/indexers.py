"""Per-partition id indexers.

A copy of the JAX package's ``cyber/indexers.py`` (host numpy; the port
imports nothing of that package). Reference: cyber/feature/indexers.py —
IdIndexer maps a string column to 1-based contiguous indices *per partition
key* (the tenant), so each tenant's id space is independent; MultiIndexer
bundles several.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.params import Param, Params
from ..core.pipeline import Estimator, Model
from ..core.table import Table


class _IdIndexerParams(Params):
    inputCol = Param("inputCol", "column to index", str)
    partitionKey = Param("partitionKey", "tenant column defining independent "
                         "index spaces", str)
    outputCol = Param("outputCol", "output index column", str)
    resetPerPartition = Param("resetPerPartition",
                              "restart indices at 1 for each partition", bool,
                              True)


class IdIndexer(Estimator, _IdIndexerParams):
    def _fit(self, df: Table) -> "IdIndexerModel":
        part = df[self.getPartitionKey()]
        vals = df[self.getInputCol()]
        vocab: Dict[Any, Dict[Any, int]] = {}
        reset = self.getResetPerPartition()
        global_next = [1]
        for p, v in zip(part, vals):
            p = p.item() if isinstance(p, np.generic) else p
            v = v.item() if isinstance(v, np.generic) else v
            per = vocab.setdefault(p, {})
            if v not in per:
                if reset:
                    per[v] = len(per) + 1
                else:
                    per[v] = global_next[0]
                    global_next[0] += 1
        return IdIndexerModel(vocabulary=vocab,
                              **{p_: self.get(p_) for p_ in self._paramMap})


class IdIndexerModel(Model, _IdIndexerParams):
    vocabulary = Param("vocabulary", "partition -> value -> index",
                       is_complex=True)

    def _transform(self, df: Table) -> Table:
        vocab = self.get("vocabulary")
        part = df[self.getPartitionKey()]
        vals = df[self.getInputCol()]
        out = np.zeros(len(vals), dtype=np.int64)  # 0 = unseen
        for i, (p, v) in enumerate(zip(part, vals)):
            p = p.item() if isinstance(p, np.generic) else p
            v = v.item() if isinstance(v, np.generic) else v
            out[i] = vocab.get(p, {}).get(v, 0)
        return df.with_column(self.getOutputCol(), out)

    def undo_transform(self, df: Table) -> Table:
        vocab = self.get("vocabulary")
        inverse: Dict[Tuple[Any, int], Any] = {
            (p, i): v for p, m in vocab.items() for v, i in m.items()}
        part = df[self.getPartitionKey()]
        idx = df[self.getOutputCol()]
        out = np.empty(len(idx), dtype=object)
        for i, (p, j) in enumerate(zip(part, idx)):
            p = p.item() if isinstance(p, np.generic) else p
            out[i] = inverse.get((p, int(j)))
        return df.with_column(self.getInputCol(), out)


class MultiIndexer(Estimator):
    """Bundle of IdIndexers (reference indexers.py:163-170)."""

    indexers = Param("indexers", "list of IdIndexer", is_complex=True)

    def __init__(self, indexers: Optional[List[IdIndexer]] = None, **kwargs):
        super().__init__(**kwargs)
        if indexers is not None:
            self.set("indexers", indexers)

    def _fit(self, df: Table) -> "MultiIndexerModel":
        models = [ix.fit(df) for ix in (self.get("indexers") or [])]
        return MultiIndexerModel(models=models)


class MultiIndexerModel(Model):
    models = Param("models", "list of IdIndexerModel", is_complex=True)

    def __init__(self, models: Optional[List[IdIndexerModel]] = None, **kwargs):
        super().__init__(**kwargs)
        if models is not None:
            self.set("models", models)

    def get_model_by_input_col(self, input_col: str) -> Optional[IdIndexerModel]:
        for m in self.get("models"):
            if m.getInputCol() == input_col:
                return m
        return None

    def get_model_by_output_col(self, output_col: str) -> Optional[IdIndexerModel]:
        for m in self.get("models"):
            if m.getOutputCol() == output_col:
                return m
        return None

    def _transform(self, df: Table) -> Table:
        cur = df
        for m in self.get("models"):
            cur = m.transform(cur)
        return cur

    def undo_transform(self, df: Table) -> Table:
        cur = df
        for m in self.get("models"):
            cur = m.undo_transform(cur)
        return cur
