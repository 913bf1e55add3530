"""ICE (Individual Conditional Expectation) / PDP explainer.

Reference: core/.../explainers/{ICEExplainer,ICEFeature}.scala — sweep each
requested feature over a grid (numeric) or its category values (categorical),
score the model at every (row, grid value), and output per-row curves
("individual" kind) or the averaged partial-dependence curve ("average").

The whole (rows × grid) sweep is materialized as one batched table and
scored in a single model.transform per feature instead of per (row,
value)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.params import Param
from ..core.table import Table
from .base import LocalExplainerBase


class ICETransformer(LocalExplainerBase):
    kind = Param("kind", "individual (per-row curves) | average (PDP)", str, "individual")
    numericFeatures = Param(
        "numericFeatures", "List of {name, numSplits?, rangeMin?, rangeMax?} dicts", list, [])
    categoricalFeatures = Param(
        "categoricalFeatures", "List of {name, numTopValues?} dicts or names", list, [])
    dependenceNameCol = Param("dependenceNameCol", "Feature-name column in output",
                              str, "featureNames")
    featureValuesCol = Param("featureValuesCol", "Grid-values column in output",
                             str, "featureValues")

    def _grid_for_numeric(self, spec: dict, col: np.ndarray) -> np.ndarray:
        splits = int(spec.get("numSplits", 10))
        lo = float(spec.get("rangeMin", np.nanmin(col)))
        hi = float(spec.get("rangeMax", np.nanmax(col)))
        grid = np.linspace(lo, hi, splits + 1)
        if np.issubdtype(col.dtype, np.integer):
            # integer feature: evaluate at integer values only and report THE
            # SAME values, so curves and featureValues stay aligned
            grid = np.unique(np.round(grid)).astype(np.float64)
        return grid.astype(np.float64)

    def _grid_for_categorical(self, spec: dict, col: np.ndarray) -> np.ndarray:
        top = int(spec.get("numTopValues", 100))
        vals, counts = np.unique(col, return_counts=True)
        order = np.argsort(-counts)
        return vals[order][:top]

    def _transform(self, df: Table) -> Table:
        n = df.num_rows
        feats: List[tuple] = []
        for spec in (self.numericFeatures or []):
            spec = {"name": spec} if isinstance(spec, str) else dict(spec)
            feats.append((spec["name"], self._grid_for_numeric(spec, np.asarray(df[spec["name"]]))))
        for spec in (self.categoricalFeatures or []):
            spec = {"name": spec} if isinstance(spec, str) else dict(spec)
            feats.append((spec["name"], self._grid_for_categorical(spec, np.asarray(df[spec["name"]]))))
        if not feats:
            raise ValueError("ICETransformer needs numericFeatures and/or categoricalFeatures")

        names_out, values_out, curves = [], [], []
        for name, grid in feats:
            g = len(grid)
            # batched sweep: tile every row g times, overwrite the swept column
            rep = {c: np.repeat(df[c], g, axis=0) for c in df.columns}
            rep[name] = np.tile(grid, n).astype(df[name].dtype, copy=False)
            y = self._score(Table(rep)).reshape(n, g, -1)    # (n, g, k)
            names_out.append(name)
            values_out.append(grid)
            curves.append(y)

        if self.kind == "average":
            rows = {self.dependenceNameCol: np.array(names_out, object),
                    self.featureValuesCol: np.array(values_out, object),
                    self.outputCol: np.array([c.mean(0) for c in curves], object)}
            return Table(rows)
        out = df.copy()
        for name, grid, y in zip(names_out, values_out, curves):
            col = np.empty(n, object)
            for i in range(n):
                col[i] = y[i]
            out[f"{self.outputCol}_{name}"] = col
        return out
