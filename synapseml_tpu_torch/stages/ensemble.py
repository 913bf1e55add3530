"""Key-wise ensembling and partition consolidation.

Reference: core/.../stages/EnsembleByKey.scala and PartitionConsolidator.scala:22-51
(SURVEY.md §2.7, §2.2 "Rate-limit consolidation").

The port's copy of the JAX package's ``stages/ensemble.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.table import Table


class EnsembleByKey(Transformer):
    """Group rows by key column(s) and aggregate chosen columns.

    Reference: stages/EnsembleByKey.scala — groupBy(keys).agg(strategy(col));
    strategy ``mean`` over scalar or vector columns; ``collapseGroup`` controls
    whether one row per group is returned or the aggregate is joined back onto
    every row; ``vectorDims`` validated against actual widths.
    """

    keys = Param("keys", "Keys to group by", list)
    cols = Param("cols", "Cols to ensemble", list)
    strategy = Param("strategy", "How to ensemble the scores, ex: mean", str, "mean")
    collapseGroup = Param("collapseGroup", "Whether to collapse all items in group to one entry", bool, True)

    def setKeys(self, keys) -> "EnsembleByKey":
        return self.set("keys", list(keys))

    def setCols(self, cols) -> "EnsembleByKey":
        return self.set("cols", list(cols))

    def _transform(self, df: Table) -> Table:
        keys: List[str] = self.getKeys()
        cols: List[str] = self.getCols()
        if self.getStrategy() != "mean":
            raise ValueError(f"Unsupported strategy {self.getStrategy()!r} (reference supports mean)")
        key_arrays = [df[k] for k in keys]
        combo = np.rec.fromarrays(key_arrays) if len(key_arrays) > 1 else key_arrays[0]
        uniq, inv = np.unique(combo, return_inverse=True)
        n_groups = len(uniq)

        agg = {}
        for c in cols:
            col = df[c]
            dense = col if col.ndim == 2 else col.astype(np.float64)[:, None]
            sums = np.zeros((n_groups, dense.shape[1]), dtype=np.float64)
            np.add.at(sums, inv, dense)
            counts = np.bincount(inv, minlength=n_groups).astype(np.float64)
            mean = sums / counts[:, None]
            agg[f"mean({c})"] = mean if col.ndim == 2 else mean[:, 0]

        if self.getCollapseGroup():
            first_idx = np.zeros(n_groups, dtype=np.int64)
            seen = np.full(n_groups, -1, dtype=np.int64)
            for i, g in enumerate(inv):
                if seen[g] < 0:
                    seen[g] = i
            first_idx = seen
            out = Table({k: df[k][first_idx] for k in keys})
            for name, arr in agg.items():
                out[name] = arr
            return out
        out = df.copy()
        for name, arr in agg.items():
            out[name] = arr[inv]
        return out


class PartitionConsolidator(Transformer):
    """Funnel many shards' rows through few workers (rate-limited services).

    Reference: stages/PartitionConsolidator.scala:22-51 — data from all
    partitions flows through ``Consolidator`` queues so only a bounded number of
    concurrent workers issue requests. In the columnar runtime rows are already
    consolidated on the host; this stage exists so pipelines carry the same
    concurrency intent: it re-shards the table to ``numPartitions`` hint and
    downstream HTTP stages read ``concurrency`` from it.
    """

    numPartitions = Param("numPartitions", "Number of partitions to consolidate down to", int, 1)
    concurrency = Param("concurrency", "Max simultaneous requests downstream", int, 1)

    def _transform(self, df: Table) -> Table:
        out = df.copy()
        out.num_shards_hint = self.getNumPartitions()
        out.concurrency_hint = self.getConcurrency()
        return out
