"""Featurize: automatic featurization of mixed-type columns into one dense
feature matrix (reference: core/.../featurize/Featurize.scala:35+ — assembles
an imputation + indexing/one-hot + assembler pipeline; here one estimator that
learns per-column plans and emits a single 2-D float column).

The port's copy of the JAX package's ``featurize/featurize.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.params import Param, HasInputCols, HasOutputCol
from ..core.pipeline import Estimator, Model
from ..core.table import Table
from ..vw.hashing import murmur3_32


class Featurize(Estimator, HasInputCols, HasOutputCol):
    oneHotEncodeCategoricals = Param("oneHotEncodeCategoricals",
                                     "One-hot (vs index) categorical columns", bool, True)
    numFeatures = Param("numFeatures", "Hash dimension for high-cardinality "
                        "string columns", int, 256)
    imputeMissing = Param("imputeMissing", "Mean-impute missing numerics", bool, True)

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "features")
        super().__init__(**kwargs)

    def _fit(self, df: Table) -> "FeaturizeModel":
        cols = list(self.inputCols or [c for c in df.columns if c != self.outputCol])
        plans: List[Dict] = []
        for c in cols:
            a = df[c]
            if a.ndim == 2:
                plans.append({"col": c, "kind": "vector", "dim": int(a.shape[1])})
            elif np.issubdtype(a.dtype, np.number) or a.dtype == bool:
                vals = np.asarray(a, np.float64)
                finite = vals[np.isfinite(vals)]
                plans.append({"col": c, "kind": "numeric",
                              "fill": float(finite.mean()) if len(finite) else 0.0})
            else:
                levels = [str(v) for v in np.unique([str(x) for x in a])]
                if self.oneHotEncodeCategoricals and len(levels) <= self.numFeatures:
                    plans.append({"col": c, "kind": "onehot", "levels": levels})
                else:
                    plans.append({"col": c, "kind": "hash", "dim": int(self.numFeatures)})
        return FeaturizeModel(inputCols=cols, outputCol=self.outputCol, plans=plans,
                              imputeMissing=self.imputeMissing)


class FeaturizeModel(Model, HasInputCols, HasOutputCol):
    plans = Param("plans", "Per-column featurization plans", list)
    imputeMissing = Param("imputeMissing", "Mean-impute missing numerics", bool, True)

    def _transform(self, df: Table) -> Table:
        n = df.num_rows
        pieces = []
        for plan in self.plans:
            a = df[plan["col"]]
            kind = plan["kind"]
            if kind == "vector":
                pieces.append(np.asarray(a, np.float32))
            elif kind == "numeric":
                v = np.asarray(a, np.float64)
                if self.imputeMissing:
                    v = np.where(np.isfinite(v), v, plan["fill"])
                pieces.append(v.astype(np.float32)[:, None])
            elif kind == "onehot":
                lut = {v: i for i, v in enumerate(plan["levels"])}
                out = np.zeros((n, len(plan["levels"])), np.float32)
                for i in range(n):
                    j = lut.get(str(a[i]))
                    if j is not None:
                        out[i, j] = 1.0
                pieces.append(out)
            elif kind == "hash":
                d = plan["dim"]
                out = np.zeros((n, d), np.float32)
                for i in range(n):
                    out[i, murmur3_32(str(a[i]).encode("utf-8")) % d] = 1.0
                pieces.append(out)
        return df.with_column(self.outputCol, np.concatenate(pieces, axis=1))

    @property
    def feature_dim(self) -> int:
        total = 0
        for p in self.plans:
            total += {"vector": p.get("dim", 0), "numeric": 1,
                      "onehot": len(p.get("levels", [])), "hash": p.get("dim", 0)}[p["kind"]]
        return total
