"""Class balancing and stratified repartitioning.

Reference: core/.../stages/ClassBalancer.scala and StratifiedRepartition.scala
(SURVEY.md §2.7).

The port's copy of the JAX package's ``stages/balance.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import numpy as np

from ..core.params import Param, HasInputCol, HasOutputCol, HasLabelCol, HasSeed
from ..core.pipeline import Estimator, Model
from ..core.table import Table
from .basic import Transformer


class ClassBalancer(Estimator, HasInputCol, HasOutputCol):
    """Compute inverse-frequency instance weights for imbalanced classes.

    Reference: stages/ClassBalancer.scala — groupBy(inputCol).count, weight =
    maxCount / count, broadcast-joined back as ``outputCol``.
    """

    outputCol = Param("outputCol", "The name of the output column", str, "weight")
    broadcastJoin = Param("broadcastJoin", "Whether to broadcast the class to weight mapping to the worker",
                          bool, True)

    def _fit(self, df: Table) -> "ClassBalancerModel":
        col = df[self.getInputCol()]
        values, counts = np.unique(col, return_counts=True)
        weights = counts.max() / counts.astype(np.float64)
        model = ClassBalancerModel(
            inputCol=self.getInputCol(), outputCol=self.getOutputCol())
        model._values = values
        model._weights = weights
        return model


class ClassBalancerModel(Model, HasInputCol, HasOutputCol):
    _values: np.ndarray
    _weights: np.ndarray

    def _transform(self, df: Table) -> Table:
        col = df[self.getInputCol()]
        idx = np.searchsorted(self._values, col)
        idx = np.clip(idx, 0, len(self._values) - 1)
        w = np.where(self._values[idx] == col, self._weights[idx], 1.0)
        return df.with_column(self.getOutputCol(), w)

    def _save_extra(self, path: str) -> None:
        np.savez(f"{path}/balancer.npz", values=self._values, weights=self._weights)

    def _load_extra(self, path: str) -> None:
        data = np.load(f"{path}/balancer.npz", allow_pickle=True)
        self._values, self._weights = data["values"], data["weights"]


class StratifiedRepartition(Transformer, HasLabelCol, HasSeed):
    """Re-order/resample rows so each of N contiguous shards sees every class.

    Reference: stages/StratifiedRepartition.scala (mode equal/original/mixed via
    DistributedStratifiedRepartition). Here shards are contiguous row ranges
    (Table.shard), so stratification = interleaving rows by class:

    * ``original``: preserve class proportions, round-robin classes across the
      table so every contiguous shard matches the global distribution.
    * ``equal``: resample (with replacement for minority classes) so every class
      has equal count, then interleave.
    * ``mixed``: like original but guarantees each class appears at least
      ``minClassOccurrence`` times per shard-sized block.
    """

    mode = Param("mode", "Specify equal to repartition with replacement across all labels, "
                 "specify original to keep the ratios in the original dataset, or specify "
                 "mixed to use a heuristic", str, "mixed")

    def _transform(self, df: Table) -> Table:
        labels = df[self.getLabelCol()]
        rng = np.random.default_rng(self.getSeed())
        classes, inv = np.unique(labels, return_inverse=True)
        idx_by_class = [np.flatnonzero(inv == c) for c in range(len(classes))]
        mode = self.getMode()
        if mode == "equal":
            target = max(len(ix) for ix in idx_by_class)
            idx_by_class = [
                ix if len(ix) == target else rng.choice(ix, size=target, replace=True)
                for ix in idx_by_class]
        pools = [rng.permutation(ix) for ix in idx_by_class]
        # proportional interleave: emit classes at evenly spaced positions
        total = sum(len(p) for p in pools)
        order = np.empty(total, dtype=np.int64)
        positions = []
        for ci, p in enumerate(pools):
            # fractional positions spread uniformly over [0, 1)
            pos = (np.arange(len(p)) + (ci + 1) / (len(pools) + 1)) / len(p)
            positions.append(pos)
        flat_idx = np.concatenate(pools)
        flat_pos = np.concatenate(positions)
        order = flat_idx[np.argsort(flat_pos, kind="stable")]
        return df.take(order)
