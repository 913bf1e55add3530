"""KernelSHAP explainers (tabular / vector / text / image).

Reference: core/.../explainers/{KernelSHAPBase,KernelSHAPSampler,TabularSHAP,
VectorSHAP,TextSHAP,ImageSHAP}.scala. Coalition sampling with Shapley-kernel
weights; weighted least squares on (coalition → model output); output vector =
[base value, shap_1..shap_M] per target class, plus the surrogate r² in
metricsCol — matching the reference's output layout."""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.params import Param
from ..core.table import Table
from ..image.superpixel import Superpixel, slic_segments
from .base import (LocalExplainerBase, default_num_samples, sample_coalitions,
                   sample_coalitions_batch, shap_kernel_lut)
from .solvers import solve_batched


class _SHAPParams(LocalExplainerBase):
    infWeight = Param("infWeight", "Parity param: the reference pins the empty/"
                      "full coalitions with this pseudo-infinite weight; here "
                      "both constraints are eliminated analytically instead "
                      "(exact, and float32-safe)", float, 1e8)

    def _fit_shap(self, coalitions: np.ndarray, y: np.ndarray, m: int,
                  base: np.ndarray = None):
        """coalitions (R,S,M) with row 0 = empty and row 1 = full, y (R,S,K) →
        (values (R,) object of (K,M+1), r2 (R,K)).

        ``base``: (R,K) expected model output on the background distribution.
        When absent-feature fills are stochastic background draws (tabular/
        vector), callers MUST pass the background mean — the single empty-
        coalition sample is one noisy draw and would corrupt every φ through
        the Σφ = f(x)−base constraint. For deterministic censoring (text/image
        masking) the empty-coalition evaluation IS the base.

        Uses the standard KernelSHAP constraint elimination: base = f(∅),
        Σφ = f(x)−base enforced exactly by substituting φ_{M-1}, then a
        finite-weight Shapley-kernel regression on the remaining M-1 players —
        numerically exact where the reference's 1e8 pseudo-weights lose the
        small-coalition signal in float32."""
        r, s, _ = coalitions.shape
        k = y.shape[2]
        if base is None:
            base = y[:, 0, :]                  # (R, K) = f(empty), deterministic case
        delta = y[:, 1, :] - base              # (R, K) = f(x) - base
        out = np.empty(r, object)

        if m == 1:
            for i in range(r):
                out[i] = np.concatenate([base[i][:, None], delta[i][:, None]], 1)
            return out, np.ones((r, k), np.float32)

        # per-row kernel weights — each row has its own coalition draw; the
        # kernel depends only on |z| so one size-indexed LUT serves all rows
        lut = shap_kernel_lut(m, inf_weight=0.0)   # empty/full rows get weight 0
        w = lut[coalitions.sum(axis=2).astype(np.int64)]
        z_last = coalitions[:, :, -1:]
        Zr = coalitions[:, :, :-1] - z_last    # (R, S, M-1)
        target = y - base[:, None, :] - z_last * delta[:, None, :]
        fit = solve_batched(Zr, target, w, 0.0,
                            device=self.getDevice())
        head = np.asarray(fit.coefs)           # (R, M-1, K)
        last = delta - head.sum(axis=1)        # (R, K)
        phi = np.concatenate([head, last[:, None, :]], axis=1)   # (R, M, K)

        # r² of the reconstructed surrogate on finite-weight coalitions
        pred = base[:, None, :] + np.einsum("rsm,rmk->rsk", coalitions, phi)
        wsum = np.maximum(w.sum(1), 1e-12)[:, None]
        ybar = (w[:, :, None] * y).sum(1) / wsum
        ss_res = (w[:, :, None] * (y - pred) ** 2).sum(1)
        ss_tot = np.maximum((w[:, :, None] * (y - ybar[:, None, :]) ** 2).sum(1), 1e-12)
        r2 = (1.0 - ss_res / ss_tot).astype(np.float32)

        for i in range(r):
            out[i] = np.concatenate([base[i][:, None], phi[i].T], axis=1)  # (K, M+1)
        return out, r2


class VectorSHAP(_SHAPParams):
    """KernelSHAP over a dense features column (VectorSHAP.scala): absent
    features take background-row values."""
    inputCol = Param("inputCol", "Features column", str, "features")
    backgroundData = Param("backgroundData", "Background Table (absent-feature fill)", object)

    def _transform(self, df: Table) -> Table:
        X = np.asarray(df[self.inputCol], np.float32)
        n, d = X.shape
        bg = self.get("backgroundData")
        bgX = np.asarray(bg[self.inputCol], np.float32) if bg is not None else X
        s = self.get("numSamples") or default_num_samples(d)
        rng = np.random.default_rng(0)

        coalitions = sample_coalitions_batch(rng, d, s, n)
        bg_rows = bgX[rng.integers(0, len(bgX), size=(n, s))]
        samples = np.where(coalitions > 0, X[:, None, :], bg_rows)
        y = self._score(Table({self.inputCol: samples.reshape(n * s, d)})).reshape(n, s, -1)
        # base = E_bg[f]: score (a subsample of) the background directly
        bg_eval = bgX if len(bgX) <= 256 else bgX[rng.choice(len(bgX), 256, replace=False)]
        base = np.tile(self._score(Table({self.inputCol: bg_eval})).mean(0), (n, 1))
        out_col, r2 = self._fit_shap(coalitions, y, d, base=base)
        out = df.with_column(self.outputCol, out_col)
        return out.with_column(self.metricsCol, r2)


class TabularSHAP(_SHAPParams):
    """KernelSHAP over named columns (TabularSHAP.scala)."""
    inputCols = Param("inputCols", "Columns to explain", list)
    backgroundData = Param("backgroundData", "Background Table", object)

    def _transform(self, df: Table) -> Table:
        cols: List[str] = list(self.inputCols or [])
        d = len(cols)
        bg = self.get("backgroundData") or df
        n = df.num_rows
        s = self.get("numSamples") or default_num_samples(d)
        rng = np.random.default_rng(0)

        coalitions = sample_coalitions_batch(rng, d, s, n)
        bg_idx = rng.integers(0, bg.num_rows, size=(n, s))
        sample_cols = {}
        for j, c in enumerate(cols):
            inst = np.asarray(df[c])
            bgv = np.asarray(bg[c])[bg_idx]                     # (n, s)
            on = coalitions[:, :, j] > 0
            merged = np.where(on, np.broadcast_to(inst[:, None], on.shape), bgv)
            sample_cols[c] = merged.reshape(-1)
        y = self._score(Table(sample_cols)).reshape(n, s, -1)
        bg_eval = bg if bg.num_rows <= 256 else bg.take(
            rng.choice(bg.num_rows, 256, replace=False))
        base = np.tile(self._score(bg_eval).mean(0), (n, 1))
        out_col, r2 = self._fit_shap(coalitions, y, d, base=base)
        out = df.with_column(self.outputCol, out_col)
        return out.with_column(self.metricsCol, r2)


class TextSHAP(_SHAPParams):
    """KernelSHAP over a text column (TextSHAP.scala): tokens are the players."""
    inputCol = Param("inputCol", "Text column", str, "text")
    tokensCol = Param("tokensCol", "Output tokens column", str, "tokens")

    def _transform(self, df: Table) -> Table:
        rng = np.random.default_rng(0)
        n = df.num_rows
        out_col = np.empty(n, object)
        tok_col = np.empty(n, object)
        r2_col = np.zeros((n, len(self.targetClasses or [0])), np.float32)
        for i in range(n):
            tokens = str(df[self.inputCol][i]).split()
            m = len(tokens)
            tok_col[i] = tokens
            if m == 0:
                out_col[i] = np.zeros((len(self.targetClasses or [0]), 1), np.float32)
                continue
            s = self.get("numSamples") or default_num_samples(m, cap=2048)
            coalitions = sample_coalitions(rng, m, s)
            texts = np.array([" ".join(t for t, b in zip(tokens, row) if b > 0)
                              for row in coalitions], object)
            y = self._score(Table({self.inputCol: texts}))
            vals, r2 = self._fit_shap(coalitions[None], y[None], m)
            out_col[i] = vals[0]
            r2_col[i] = r2[0]
        out = df.with_column(self.tokensCol, tok_col)
        out = out.with_column(self.outputCol, out_col)
        return out.with_column(self.metricsCol, r2_col)


class ImageSHAP(_SHAPParams):
    """KernelSHAP over an image column (ImageSHAP.scala): superpixels are the
    players; absent superpixels are censored to the fill color."""
    inputCol = Param("inputCol", "Image column", str, "image")
    superpixelCol = Param("superpixelCol", "Output segmentation column", str, "superpixels")
    cellSize = Param("cellSize", "Superpixel cell size", float, 16.0)
    modifier = Param("modifier", "Superpixel compactness", float, 130.0)

    def _transform(self, df: Table) -> Table:
        rng = np.random.default_rng(0)
        n = df.num_rows
        out_col = np.empty(n, object)
        seg_col = np.empty(n, object)
        r2_col = np.zeros((n, len(self.targetClasses or [0])), np.float32)
        for i in range(n):
            img = np.asarray(df[self.inputCol][i])
            segs = slic_segments(img, int(self.cellSize), self.modifier)
            k = int(segs.max()) + 1
            seg_col[i] = segs
            s = self.get("numSamples") or default_num_samples(k, cap=1024)
            coalitions = sample_coalitions(rng, k, s)
            imgs = np.empty(s, object)
            for j in range(s):
                imgs[j] = Superpixel.masked_image(img, segs, coalitions[j])
            y = self._score(Table({self.inputCol: imgs}))
            vals, r2 = self._fit_shap(coalitions[None], y[None], k)
            out_col[i] = vals[0]
            r2_col[i] = r2[0]
        out = df.with_column(self.superpixelCol, seg_col)
        out = out.with_column(self.outputCol, out_col)
        return out.with_column(self.metricsCol, r2_col)
