"""Hash-trick featurization transformers.

Reference: vw/.../VowpalWabbitFeaturizer.scala + featurizer/*.scala (11 element
featurizers: Numeric/String/Map/Seq/Struct/Vector/Boolean/StringSplit) and
VowpalWabbitInteractions.scala. All JVM-side there; all host-side NumPy here,
producing the padded sparse (idx, val) structured column the port's learner
consumes (learner.SPARSE_DTYPE)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.params import Param, HasInputCols, HasOutputCol
from ..core.pipeline import Transformer
from ..core.table import Table
from .hashing import hash_feature, hash_strings, interaction_hash, namespace_hash
from .learner import SPARSE_DTYPE, make_sparse_batch


class VowpalWabbitFeaturizer(Transformer, HasInputCols, HasOutputCol):
    """Hash DataFrame columns into one sparse VW-style feature column.

    Per-element behavior mirrors the reference's element featurizers
    (vw/.../featurizer/*.scala):
      numeric        → index = hash(colName), value = x
      string         → index = hash(colName + "=" + s), value = 1
      bool           → index = hash(colName), value = 1 if true
      list/array of strings → one string feature per element
      numeric vector → index = hash(colName + "_" + i) (or i + seed), value = x[i]
    """
    numBits = Param("numBits", "Number of hash bits (feature space = 2^numBits)", int, 18)
    hashSeed = Param("hashSeed", "Hash seed (--hash_seed)", int, 0)
    sumCollisions = Param("sumCollisions", "Sum values on hash collisions", bool, True)
    prefixStringsWithColumnName = Param(
        "prefixStringsWithColumnName", "Prefix string features with the column name", bool, True)
    preserveOrderNumBits = Param(
        "preserveOrderNumBits", "Bits reserved to preserve input order (unused, parity)", int, 0)

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "features")
        super().__init__(**kwargs)

    def _featurize_row_cols(self, df: Table) -> tuple:
        bits = self.numBits
        mask = (1 << bits) - 1
        n = df.num_rows
        idxs: List[list] = [[] for _ in range(n)]
        vals: List[list] = [[] for _ in range(n)]
        for col in (self.inputCols or []):
            a = df[col]
            seed = namespace_hash("", self.hashSeed)
            if a.ndim == 2:                                  # numeric vector column
                hs = hash_strings([f"{col}_{j}" for j in range(a.shape[1])],
                                  seed, num_bits=bits)
                for i in range(n):
                    row = np.asarray(a[i], np.float32)
                    nz = np.nonzero(row)[0]
                    idxs[i].extend(hs[nz].tolist())
                    vals[i].extend(row[nz].tolist())
            elif np.issubdtype(a.dtype, np.number) or a.dtype == bool:
                h = hash_feature(col, seed) & mask
                av = np.asarray(a, np.float32)
                for i in range(n):
                    if av[i] != 0.0:
                        idxs[i].append(h)
                        vals[i].append(float(av[i]))
            else:                                            # strings / lists of strings
                prefix = col if self.prefixStringsWithColumnName else ""
                for i in range(n):
                    v = a[i]
                    elems = v if isinstance(v, (list, tuple, np.ndarray)) else [v]
                    for e in elems:
                        if e is None:
                            continue
                        name = f"{prefix}={e}" if prefix else str(e)
                        idxs[i].append(hash_feature(name, seed) & mask)
                        vals[i].append(1.0)
        return idxs, vals

    def _transform(self, df: Table) -> Table:
        idxs, vals = self._featurize_row_cols(df)
        if self.sumCollisions:
            for i in range(len(idxs)):
                if len(set(idxs[i])) != len(idxs[i]):
                    agg: dict = {}
                    for h, v in zip(idxs[i], vals[i]):
                        agg[h] = agg.get(h, 0.0) + v
                    idxs[i], vals[i] = list(agg.keys()), list(agg.values())
        return df.with_column(self.outputCol, make_sparse_batch(idxs, vals))


class VowpalWabbitInteractions(Transformer, HasInputCols, HasOutputCol):
    """Cross sparse feature columns — the -q/--interactions analog done as a
    transformer (reference: VowpalWabbitInteractions.scala). Input columns must
    be SPARSE_DTYPE columns (from VowpalWabbitFeaturizer); the output is the
    full cartesian interaction of each row's features across the columns."""
    numBits = Param("numBits", "Number of hash bits", int, 18)
    sumCollisions = Param("sumCollisions", "Sum values on hash collisions", bool, True)

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "interactions")
        super().__init__(**kwargs)

    def _transform(self, df: Table) -> Table:
        cols = [df[c] for c in (self.inputCols or [])]
        if not cols or any(c.dtype != SPARSE_DTYPE for c in cols):
            raise ValueError("VowpalWabbitInteractions needs SPARSE_DTYPE input columns")
        mask = (1 << self.numBits) - 1
        n = df.num_rows
        idxs, vals = [], []
        for i in range(n):
            combos = [(None, 1.0)]
            for c in cols:
                row = c[i]
                live = row["val"] != 0
                feats = list(zip(row["idx"][live].tolist(), row["val"][live].tolist()))
                if not feats:
                    combos = []
                    break
                combos = [((h if ph is None else interaction_hash(ph, h)), pv * v)
                          for (ph, pv) in combos for (h, v) in feats]
            agg: dict = {}
            for h, v in combos:
                k = (h if h is not None else 0) & mask
                agg[k] = agg.get(k, 0.0) + v if self.sumCollisions else v
            idxs.append(list(agg.keys()))
            vals.append(list(agg.values()))
        return df.with_column(self.outputCol, make_sparse_batch(idxs, vals))
