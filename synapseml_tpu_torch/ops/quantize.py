"""Quantile bin mapper and binning.

Counterpart of the JAX package's ``ops/quantize.py``. ``BinMapper`` and
``compute_bin_mapper`` are its numpy logic, copied: bin boundaries come from a
host-side row sample exactly as there, so both packages bin identically.
``apply_bins`` runs on the device as one ``torch.searchsorted(side="left")``
over all features, giving exactly the reference's bins.

Bin semantics (matching LightGBM's BinMapper):
  * boundaries[f] is a sorted vector of bin upper bounds (length <= max_bin - 1);
    bin(x) = first i with x <= boundaries[f][i]; x beyond all bounds → last
    real-value bin.
  * Features containing NaN get a DEDICATED missing bin at index
    ``num_bins[f] - 1``; the split finder learns the missing direction per
    split (``default_left``).

Categorical features and sparse input are not ported: ``apply_bins`` rejects
a mapper with categorical features.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class BinMapper(NamedTuple):
    """Per-feature binning metadata. ``boundaries`` is padded to a rectangle
    (num_features, max_bin-1) with +inf so it ships to device as one array."""

    boundaries: np.ndarray      # (F, max_bin-1) float32, +inf padded
    num_bins: np.ndarray        # (F,) int32 — actual bin count per feature
    is_categorical: np.ndarray  # (F,) bool
    max_bin: int
    has_nan: np.ndarray = None  # (F,) bool — feature has a dedicated NaN bin
    cat_counts: np.ndarray = None  # (F,) int32 — DISTINCT categories observed
                                   # (sparse id encodings differ from num_bins)

    @property
    def num_features(self) -> int:
        return self.boundaries.shape[0]

    @property
    def nan_mask(self) -> np.ndarray:
        if self.has_nan is None:
            return np.zeros(self.num_features, bool)
        return self.has_nan

    @property
    def nan_bins(self) -> np.ndarray:
        """(F,) int32: the NaN bin index per feature (num_bins-1 when the
        feature has missing values, else an out-of-range sentinel so equality
        against it never fires)."""
        nb = np.asarray(self.num_bins, np.int32) - 1
        return np.where(self.nan_mask, nb, np.int32(0x7FFF))


def compute_bin_mapper(
    X: np.ndarray,
    max_bin: int = 255,
    sample_count: int = 200_000,
    seed: int = 0,
    min_data_in_bin: int = 3,
    max_bin_by_feature: Optional[Sequence[int]] = None,
) -> BinMapper:
    """Driver-side boundary computation from a sample (the analog of
    LightGBMBase.getSampledRows + LGBM_DatasetCreateFromSampledColumn;
    binSampleCount param default 200000 — params/LightGBMParams.scala).
    Numeric features only: the JAX package's categorical and sparse-path
    arguments are not ported."""
    X = np.asarray(X, dtype=np.float32)
    n, f = X.shape
    # missing-ness decided on the FULL matrix (binning must route every NaN)
    has_nan = np.isnan(X).any(axis=0)
    if n > sample_count:
        rng = np.random.default_rng(seed)
        X = X[rng.choice(n, size=sample_count, replace=False)]

    bounds = np.full((f, max_bin - 1), np.inf, dtype=np.float32)
    nbins = np.zeros(f, dtype=np.int32)
    caps = np.full(f, max_bin, np.int64)
    if max_bin_by_feature is not None:
        mb = np.asarray(max_bin_by_feature, np.int64)
        caps[: len(mb)] = np.clip(mb[:f], 2, max_bin)
    for j in range(f):
        col = X[:, j]
        col = col[~np.isnan(col)]
        # features with NaN reserve one bin; real values get one fewer
        real_cap = int(caps[j]) - 1 if has_nan[j] else int(caps[j])
        uniq = np.unique(col)
        if uniq.size <= 1:
            nbins[j] = 2 + int(has_nan[j])
            continue
        if uniq.size <= real_cap - 1:
            # few distinct values: boundary at midpoints → exact value bins
            b = (uniq[:-1] + uniq[1:]) * 0.5
        else:
            qs = np.linspace(0.0, 1.0, real_cap)[1:-1]
            b = np.unique(np.quantile(col, qs).astype(np.float32))
        if min_data_in_bin > 1 and b.size:
            # merge bins whose SAMPLE occupancy is below min_data_in_bin
            # (LightGBM minDataPerBin): drop a boundary when the bin it
            # closes is under-filled
            # right-closed counting (x <= boundary belongs to the LEFT bin),
            # matching apply_bins' searchsorted side='left' semantics
            counts = np.bincount(np.searchsorted(b, col, side="left"),
                                 minlength=b.size + 1)
            keep = []
            acc = 0
            for bi in range(b.size):
                acc += counts[bi]
                if acc >= min_data_in_bin:
                    keep.append(bi)
                    acc = 0
            # the trailing (overflow) bin may be under-filled: merge backward
            if keep and counts[b.size] + acc < min_data_in_bin:
                keep.pop()
            b = b[keep]
        bounds[j, : b.size] = b
        # bins: b.size+1 real-value bins (+1 overflow shares the last), plus a
        # dedicated NaN bin when the feature has missing values
        nbins[j] = b.size + 2 + int(has_nan[j])
    return BinMapper(boundaries=bounds, num_bins=nbins,
                     is_categorical=np.zeros(f, bool), max_bin=max_bin,
                     has_nan=has_nan, cat_counts=np.zeros(f, np.int32))


def apply_bins(mapper: BinMapper, X, device="cuda") -> torch.Tensor:
    """(N, F) raw floats → (N, F) bin ids on ``device`` (uint8 when
    max_bin <= 256, else int32). Non-NaN overflow clamps into the last REAL
    value bin; NaN goes to the feature's dedicated NaN bin when it has one."""
    from ..core.device import resolve_device

    if mapper.is_categorical.any():
        raise NotImplementedError(
            "categorical features are not ported to the PyTorch package yet")
    dev = resolve_device(device)
    X = torch.as_tensor(np.asarray(X, np.float32)).to(dev)
    bounds = torch.as_tensor(np.asarray(mapper.boundaries, np.float32)).to(dev)
    binned = torch.searchsorted(bounds, X.T.contiguous(), side="left").T
    nan_mask = torch.as_tensor(np.asarray(mapper.nan_mask, bool)).to(dev)
    num_bins = torch.as_tensor(np.asarray(mapper.num_bins, np.int64)).to(dev)
    real_limit = num_bins - 1 - nan_mask.to(torch.int64)
    binned = torch.minimum(binned, real_limit[None, :])
    binned = torch.where(torch.isnan(X) & nan_mask[None, :],
                         (num_bins - 1)[None, :], binned)
    return binned.to(torch.uint8 if mapper.max_bin <= 256 else torch.int32)


def bin_threshold_to_value(mapper: BinMapper, feature: int, bin_id: int) -> float:
    """Real-valued split threshold for a numeric split at ``bin_id`` (the stored
    LightGBM model threshold, i.e. the bin's upper boundary). A threshold at or
    beyond the last real-value bin means "every non-missing value goes left"
    (only reachable for features with a NaN bin, where the right child holds
    the missing rows). Serialized as a large FINITE double (1e308) so model
    strings stay parseable everywhere (LightGBM also emits finite doubles
    for top-bin thresholds) while x <= threshold holds for every real x."""
    b = mapper.boundaries[feature]
    if bin_id < len(b) and np.isfinite(b[bin_id]):
        return float(b[bin_id])
    return 1e308
