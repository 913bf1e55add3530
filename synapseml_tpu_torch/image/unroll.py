"""UnrollImage + ImageSetAugmenter: a host numpy copy of the JAX package's
``image/unroll.py``.

Reference: core/.../image/UnrollImage.scala:169-204 (image → flat vector
column, the bridge from image data to vector-consuming estimators) and
opencv/.../ImageSetAugmenter.scala (flip-based augmentation that doubles the
dataset)."""

from __future__ import annotations

import numpy as np

from ..core.params import Param, HasInputCol, HasOutputCol
from ..core.pipeline import Transformer
from ..core.table import Table


class UnrollImage(Transformer, HasInputCol, HasOutputCol):
    """Flatten an image column (H,W,C arrays) into a 2-D float vector column."""

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "features")
        super().__init__(**kwargs)

    def _transform(self, df: Table) -> Table:
        imgs = df[self.inputCol]
        flat = [np.asarray(imgs[i], np.float32).ravel() for i in range(df.num_rows)]
        dims = {len(f) for f in flat}
        if len(dims) > 1:
            raise ValueError(
                f"UnrollImage requires uniformly-sized images; got flattened "
                f"lengths {sorted(dims)} — resize/crop first (ops.image)")
        d = dims.pop() if dims else 0
        out = np.stack(flat) if flat else np.zeros((0, d), np.float32)
        return df.with_column(self.outputCol, out)


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol):
    """Double the dataset with horizontal (and optionally vertical) flips."""
    flipLeftRight = Param("flipLeftRight", "Add left-right flipped copies", bool, True)
    flipUpDown = Param("flipUpDown", "Add up-down flipped copies", bool, False)

    def __init__(self, **kwargs):
        kwargs.setdefault("outputCol", "images")
        super().__init__(**kwargs)

    def _transform(self, df: Table) -> Table:
        imgs = df[self.inputCol]
        base = (df.rename({self.inputCol: self.outputCol})
                if self.inputCol != self.outputCol else df.copy())
        pieces = [base]
        for flag, axis in ((self.flipLeftRight, 1), (self.flipUpDown, 0)):
            if not flag:
                continue
            flipped = np.empty(df.num_rows, object)
            for i in range(df.num_rows):
                flipped[i] = np.flip(np.asarray(imgs[i]), axis=axis).copy()
            # preserve base's column order exactly (concat requires it)
            t = Table({c: (flipped if c == self.outputCol else base[c])
                       for c in base.columns})
            pieces.append(t)
        return pieces[0].concat(*pieces[1:]) if len(pieces) > 1 else pieces[0]
