"""Pre-binned training data — the LightGBM ``Dataset`` concept on the card.

Counterpart of the JAX package's ``gbdt/dataset.py``, dense input only.
LightGBM separates dataset construction (quantile binning, the expensive
O(N·F·log B) pass) from training; ``Dataset`` bins once on ``device`` at
construction and keeps the quantized (N, F) matrix resident there, so every
``train_booster(dataset, ...)`` call skips binning and the host→device copy
of the raw floats. Sparse input and ``from_batches`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..ops.quantize import BinMapper, apply_bins, compute_bin_mapper


def _is_sparse(X) -> bool:
    return hasattr(X, "tocsr") and hasattr(X, "nnz")


class Dataset:
    """Bins ``X`` once (resident on ``device``) for repeated training runs.

    Parameters mirror the binning-relevant subset of ``BoosterConfig``
    (max_bin / bin_sample_count / seed). ``label`` / ``weight`` ride along so
    a Dataset is a self-contained training input.
    """

    def __init__(
        self,
        X: np.ndarray,
        label: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        categorical_features: Optional[Sequence[int]] = None,
        max_bin: int = 255,
        bin_sample_count: int = 200_000,
        seed: int = 0,
        mapper: Optional[BinMapper] = None,
        keep_raw: bool = True,
        min_data_in_bin: int = 3,
        max_bin_by_feature=None,
        device=DEFAULT_DEVICE,
    ):
        if _is_sparse(X):
            raise NotImplementedError(
                "sparse input is not ported to the PyTorch package yet; "
                "pass a dense matrix")
        if categorical_features:
            raise NotImplementedError(
                "categorical_features are not ported to the PyTorch package "
                "yet")
        self.device = resolve_device(device)
        X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError(
                f"Dataset requires a non-empty 2-D matrix, got {X.shape}")
        self.num_rows, self.num_features = X.shape
        self.mapper = mapper if mapper is not None else compute_bin_mapper(
            X, max_bin, bin_sample_count, seed,
            min_data_in_bin=min_data_in_bin,
            max_bin_by_feature=max_bin_by_feature)
        self.binned = apply_bins(self.mapper, X, self.device)
        # raw floats kept host-side for callers that want them back; drop
        # with keep_raw=False to halve host memory
        self.X = X if keep_raw else None
        self.label = None if label is None else np.asarray(label, np.float32)
        self.weight = None if weight is None else np.asarray(weight, np.float32)

    @property
    def shape(self):
        return (self.num_rows, self.num_features)
