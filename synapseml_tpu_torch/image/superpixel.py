"""Superpixel segmentation: a host numpy copy of the JAX package's
``image/superpixel.py``.

Reference: core/.../image/Superpixel.scala:147+ — SLIC-style clustering used by
image LIME/SHAP samplers, and SuperpixelTransformer. The reference's cluster
loop is scalar JVM code; here the SLIC iterations are vectorized NumPy
(assignment via distance to K cluster centers in (L,a,b,x,y)-ish space done as
one broadcast op per iteration). Segmentation is a host-side preprocessing
step feeding the explainers, and the same arithmetic as the JAX package's
gives the same labels."""

from __future__ import annotations


import numpy as np

from ..core.params import Param, HasInputCol, HasOutputCol
from ..core.pipeline import Transformer
from ..core.table import Table


def grid_segments(h: int, w: int, cell: int = 16) -> np.ndarray:
    """Regular-grid fallback segmentation: (h, w) int32 segment ids."""
    gy = np.arange(h) // cell
    gx = np.arange(w) // cell
    ncols = (w + cell - 1) // cell
    return (gy[:, None] * ncols + gx[None, :]).astype(np.int32)


def slic_segments(img: np.ndarray, cell_size: int = 16, modifier: float = 10.0,
                  iters: int = 5) -> np.ndarray:
    """SLIC superpixels: k-means in (color, compactness-weighted position).

    img: (H, W, C) float or uint8. Returns (H, W) int32 segment labels
    relabeled to 0..K-1. `cell_size`/`modifier` mirror Superpixel.scala's
    cellSize/modifier params."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    s = max(min(int(cell_size), h, w), 2)  # clamp so tiny images get >= 1 center
    # initial centers on a regular grid
    ys = np.arange(s // 2, h, s)
    xs = np.arange(s // 2, w, s)
    if len(ys) == 0 or len(xs) == 0:
        return np.zeros((h, w), np.int32)  # degenerate image: one segment
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    cy, cx = cy.ravel().astype(np.float32), cx.ravel().astype(np.float32)
    k = len(cy)
    centers_col = img[cy.astype(int), cx.astype(int)]                  # (K, C)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    ratio = (modifier / s) ** 2
    flat = img.reshape(-1, c)
    pos = np.stack([yy.ravel(), xx.ravel()], 1)                        # (HW, 2)
    labels = np.zeros(h * w, np.int32)
    for _ in range(max(iters, 1)):
        # distance of every pixel to every center (vectorized; K is small)
        d_col = ((flat[:, None, :] - centers_col[None]) ** 2).sum(-1)  # (HW, K)
        d_pos = (pos[:, None, 0] - cy[None]) ** 2 + (pos[:, None, 1] - cx[None]) ** 2
        labels = np.argmin(d_col + ratio * d_pos, axis=1).astype(np.int32)
        # recompute centers
        for j in range(k):
            m = labels == j
            if m.any():
                centers_col[j] = flat[m].mean(0)
                cy[j] = pos[m, 0].mean()
                cx[j] = pos[m, 1].mean()
    # relabel contiguously
    uniq, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(h, w).astype(np.int32)


class Superpixel:
    """Functional facade matching the reference's Superpixel object."""

    @staticmethod
    def cluster(img: np.ndarray, cell_size: int = 16, modifier: float = 130.0,
                iters: int = 5) -> np.ndarray:
        return slic_segments(img, cell_size, modifier, iters)

    @staticmethod
    def masked_image(img: np.ndarray, segments: np.ndarray, mask: np.ndarray,
                     fill: float = 0.0) -> np.ndarray:
        """Zero/fill the superpixels where mask[seg]==0 (the LIME censoring op)."""
        keep = np.asarray(mask)[segments].astype(bool)
        out = np.array(img, np.float32, copy=True)
        out[~keep] = fill
        return out


class SuperpixelTransformer(Transformer, HasInputCol, HasOutputCol):
    """Adds a segmentation (H, W) label map column for an image column
    (reference: image/SuperpixelTransformer.scala)."""
    cellSize = Param("cellSize", "Approximate superpixel cell size (pixels)", float, 16.0)
    modifier = Param("modifier", "Compactness modifier", float, 130.0)

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "superpixels")
        super().__init__(**kwargs)

    def _transform(self, df: Table) -> Table:
        imgs = df[self.inputCol]
        segs = np.empty(df.num_rows, object)
        for i in range(df.num_rows):
            segs[i] = slic_segments(np.asarray(imgs[i]), int(self.cellSize), self.modifier)
        return df.with_column(self.outputCol, segs)
