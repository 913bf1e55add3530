"""RecommendationIndexer — raw user/item ids → contiguous integer indices.

A copy of the JAX package's ``recommendation/indexer.py`` (host numpy; the
port imports nothing of that package). Reference:
recommendation/RecommendationIndexer.scala (wraps two StringIndexers
and exposes recover-transformers). SAR needs dense [U, I] matrices, so ids are
mapped to 0..n-1; the fitted model also recovers original ids on output tables.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..core.params import Param, Params
from ..core.pipeline import Estimator, Model
from ..core.table import Table


class _IndexerParams(Params):
    userInputCol = Param("userInputCol", "User column", str, "user")
    userOutputCol = Param("userOutputCol", "User index column", str)
    itemInputCol = Param("itemInputCol", "Item column", str, "item")
    itemOutputCol = Param("itemOutputCol", "Item index column", str)
    ratingCol = Param("ratingCol", "Rating column", str, "rating")


class RecommendationIndexer(Estimator, _IndexerParams):
    def _fit(self, df: Table) -> "RecommendationIndexerModel":
        users = _vocabulary(df[self.getUserInputCol()])
        items = _vocabulary(df[self.getItemInputCol()])
        return RecommendationIndexerModel(
            userMap=users, itemMap=items,
            **{p: self.get(p) for p in self._paramMap})


class RecommendationIndexerModel(Model, _IndexerParams):
    userMap = Param("userMap", "user id -> index", is_complex=True)
    itemMap = Param("itemMap", "item id -> index", is_complex=True)

    def _transform(self, df: Table) -> Table:
        out = df.copy()
        umap: Dict[Any, int] = self.get("userMap")
        imap: Dict[Any, int] = self.get("itemMap")
        u_out = self.get("userOutputCol") or self.getUserInputCol() + "_idx"
        i_out = self.get("itemOutputCol") or self.getItemInputCol() + "_idx"
        if self.getUserInputCol() in df:
            out[u_out] = np.asarray(
                [umap[v] for v in df[self.getUserInputCol()]], dtype=np.int32)
        if self.getItemInputCol() in df:
            out[i_out] = np.asarray(
                [imap[v] for v in df[self.getItemInputCol()]], dtype=np.int32)
        return out

    @property
    def num_users(self) -> int:
        return len(self.get("userMap"))

    @property
    def num_items(self) -> int:
        return len(self.get("itemMap"))

    def recover_users(self, idx) -> List[Any]:
        inv = _inverse(self.get("userMap"))
        return [inv[int(i)] for i in np.asarray(idx).ravel()]

    def recover_items(self, idx) -> List[Any]:
        inv = _inverse(self.get("itemMap"))
        return [inv[int(i)] for i in np.asarray(idx).ravel()]

    recoverUsers = recover_users
    recoverItems = recover_items


def _vocabulary(col: np.ndarray) -> Dict[Any, int]:
    seen: Dict[Any, int] = {}
    for v in col:
        key = v.item() if isinstance(v, np.generic) else v
        if key not in seen:
            seen[key] = len(seen)
    return seen


def _inverse(m: Dict[Any, int]) -> Dict[int, Any]:
    return {i: v for v, i in m.items()}
