"""LIME explainers (tabular / vector / text / image).

Reference: core/.../explainers/{LIMEBase,LIMESampler,TabularLIME,VectorLIME,
TextLIME,ImageLIME}.scala. Flow per instance: draw numSamples perturbations,
score through the wrapped model, weight by a locality kernel, fit a (lasso)
linear surrogate; output its coefficients.

For tabular/vector ALL rows' samples go through the model in ONE batched
transform and ALL local regressions solve in one batched call per bucket
of rows (solvers.solve_batched, on the explainer's device) — the reference
loops rows and solves with Breeze on the driver."""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.params import Param
from ..core.table import Table
from ..image.superpixel import Superpixel, slic_segments
from .base import LocalExplainerBase, coefs_to_column, lime_kernel_weights
from .solvers import solve_batched


class _LIMEParams(LocalExplainerBase):
    kernelWidth = Param("kernelWidth", "Locality kernel width (fraction of sqrt(D))",
                        float, 0.75)
    regularization = Param("regularization", "Lasso regularization strength", float, 0.0)


class VectorLIME(_LIMEParams):
    """LIME over a dense 2-D features column (VectorLIME.scala)."""
    inputCol = Param("inputCol", "Features column to explain", str, "features")
    backgroundData = Param("backgroundData", "Background Table for sampling stats", object)

    def _transform(self, df: Table) -> Table:
        X = np.asarray(df[self.inputCol], np.float32)
        n, d = X.shape
        bg = self.get("backgroundData")
        bgX = np.asarray(bg[self.inputCol], np.float32) if bg is not None else X
        mu, sd = bgX.mean(0), bgX.std(0) + 1e-12
        s = self.get("numSamples") or 1000
        rng = np.random.default_rng(0)

        # (n, s, d) perturbations around each instance
        noise = rng.normal(size=(n, s, d)).astype(np.float32)
        samples = X[:, None, :] + noise * sd[None, None, :]
        states = (samples - mu) / sd                         # standardized regressors
        dist = np.sqrt((noise ** 2).sum(-1))                 # scaled distance
        kw = self.kernelWidth * np.sqrt(d)
        weights = lime_kernel_weights(dist, kw)

        flat = Table({self.inputCol: samples.reshape(n * s, d)})
        y = self._score(flat).reshape(n, s, -1)
        fit = solve_batched(states, y, weights, self.regularization,
                            device=self.getDevice())
        out = df.with_column(self.outputCol, coefs_to_column(np.asarray(fit.coefs)))
        return out.with_column(self.metricsCol, np.asarray(fit.r2))


class TabularLIME(_LIMEParams):
    """LIME over named numeric columns (TabularLIME.scala): samples are drawn
    from the background distribution per column; categorical columns perturb by
    resampling background values with a same-as-instance binary regressor."""
    inputCols = Param("inputCols", "Columns to explain", list)
    categoricalFeatures = Param("categoricalFeatures", "Which inputCols are categorical",
                                list, [])
    backgroundData = Param("backgroundData", "Background Table", object)

    def _transform(self, df: Table) -> Table:
        cols: List[str] = list(self.inputCols or [])
        cats = set(self.categoricalFeatures or [])
        bg = self.get("backgroundData") or df
        n = df.num_rows
        s = self.get("numSamples") or 1000
        d = len(cols)
        rng = np.random.default_rng(0)
        kw = self.kernelWidth * np.sqrt(d)

        states = np.empty((n, s, d), np.float32)
        sample_cols = {}
        dist2 = np.zeros((n, s), np.float32)
        for j, c in enumerate(cols):
            bgv = np.asarray(bg[c])
            inst = np.asarray(df[c])
            if c in cats or bgv.dtype == object:
                draw = rng.choice(bgv, size=(n, s))
                same = (draw == inst[:, None]).astype(np.float32)
                states[:, :, j] = same
                dist2 += (1.0 - same)
                sample_cols[c] = draw.reshape(-1)
            else:
                mu, sd = float(bgv.mean()), float(bgv.std()) + 1e-12
                noise = rng.normal(size=(n, s)).astype(np.float32)
                draw = inst[:, None].astype(np.float32) + noise * sd
                if np.issubdtype(inst.dtype, np.integer):
                    # score and regress on the SAME values: round first so the
                    # surrogate never sees variation the model didn't
                    draw = np.round(draw)
                states[:, :, j] = (draw - mu) / sd
                dist2 += ((draw - inst[:, None]) / sd) ** 2
                sample_cols[c] = draw.reshape(-1).astype(inst.dtype, copy=False)
        weights = lime_kernel_weights(np.sqrt(dist2), kw)

        flat = Table(sample_cols)
        y = self._score(flat).reshape(n, s, -1)
        fit = solve_batched(states, y, weights, self.regularization,
                            device=self.getDevice())
        out = df.with_column(self.outputCol, coefs_to_column(np.asarray(fit.coefs)))
        return out.with_column(self.metricsCol, np.asarray(fit.r2))


class TextLIME(_LIMEParams):
    """LIME over a text column (TextLIME.scala): binary token masking; the
    surrogate weighs each token's contribution."""
    inputCol = Param("inputCol", "Text column", str, "text")
    tokensCol = Param("tokensCol", "Output column of tokens", str, "tokens")
    samplingFraction = Param("samplingFraction", "Probability a token is kept", float, 0.7)

    def _transform(self, df: Table) -> Table:
        rng = np.random.default_rng(0)
        s = self.get("numSamples") or 1000
        n = df.num_rows
        out_col = np.empty(n, object)
        tok_col = np.empty(n, object)
        r2_col = np.zeros((n,), np.float32)
        for i in range(n):
            tokens = str(df[self.inputCol][i]).split()
            m = len(tokens)
            tok_col[i] = tokens
            if m == 0:
                out_col[i] = np.zeros((len(self.targetClasses or [0]), 0), np.float32)
                continue
            mask = (rng.random((s, m)) < self.samplingFraction).astype(np.float32)
            mask[0] = 1.0
            texts = np.array([" ".join(t for t, b in zip(tokens, row) if b > 0)
                              for row in mask], object)
            y = self._score(Table({self.inputCol: texts}))
            dist = 1.0 - mask.mean(1)
            weights = lime_kernel_weights(dist, self.kernelWidth)
            fit = solve_batched(mask[None], y[None], weights[None],
                                self.regularization, device=self.getDevice())
            out_col[i] = np.asarray(fit.coefs)[0].T
            r2_col[i] = float(np.asarray(fit.r2)[0].mean())
        out = df.with_column(self.tokensCol, tok_col)
        out = out.with_column(self.outputCol, out_col)
        return out.with_column(self.metricsCol, r2_col)


class ImageLIME(_LIMEParams):
    """LIME over an image column (ImageLIME.scala): superpixel masking; outputs
    per-superpixel weights + the segmentation map."""
    inputCol = Param("inputCol", "Image column (H,W,C arrays)", str, "image")
    superpixelCol = Param("superpixelCol", "Output segmentation column", str, "superpixels")
    cellSize = Param("cellSize", "Superpixel cell size", float, 16.0)
    modifier = Param("modifier", "Superpixel compactness", float, 130.0)
    samplingFraction = Param("samplingFraction", "Probability a superpixel is kept",
                             float, 0.7)

    def _transform(self, df: Table) -> Table:
        rng = np.random.default_rng(0)
        s = self.get("numSamples") or 256
        n = df.num_rows
        out_col = np.empty(n, object)
        seg_col = np.empty(n, object)
        r2_col = np.zeros((n,), np.float32)
        for i in range(n):
            img = np.asarray(df[self.inputCol][i])
            segs = slic_segments(img, int(self.cellSize), self.modifier)
            k = int(segs.max()) + 1
            seg_col[i] = segs
            mask = (rng.random((s, k)) < self.samplingFraction).astype(np.float32)
            mask[0] = 1.0
            imgs = np.empty(s, object)
            for j in range(s):
                imgs[j] = Superpixel.masked_image(img, segs, mask[j])
            y = self._score(Table({self.inputCol: imgs}))
            dist = 1.0 - mask.mean(1)
            weights = lime_kernel_weights(dist, self.kernelWidth)
            fit = solve_batched(mask[None], y[None], weights[None],
                                self.regularization, device=self.getDevice())
            out_col[i] = np.asarray(fit.coefs)[0].T
            r2_col[i] = float(np.asarray(fit.r2)[0].mean())
        out = df.with_column(self.superpixelCol, seg_col)
        out = out.with_column(self.outputCol, out_col)
        return out.with_column(self.metricsCol, r2_col)
