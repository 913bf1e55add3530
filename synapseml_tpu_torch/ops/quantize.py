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
  * categorical features use the category's integer value as its bin, capped
    by max_bin (values past the last observed category share one overflow
    bin); NaN and negative categories go to bin 0.

Sparse (scipy CSR) rows bin through ``CsrBinner``: each chunk starts as a
broadcast of the bins of an all-zero row and only the explicit entries'
bins are scattered in, so the implicit zeros never materialise as floats.

Streamed rows (``gbdt/stream.py``) learn their boundaries through
``StreamingQuantileSketch``: one pass of chunks, exact while the stream
fits its sample buffer (then ``finalize`` is ``compute_bin_mapper`` over
every row, boundaries byte for byte), a seeded reservoir past it.
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


def cat_presence_bitmap(col: np.ndarray, cap: int) -> np.ndarray:
    """(cap,) bool: which identity bins a categorical column occupies.
    Values clip into [0, cap-1] exactly as identity binning does, so the
    popcount equals the number of distinct OBSERVED bins — the quantity the
    maxCatToOnehot one-vs-rest decision needs (LightGBM decides from
    full-data bin counts). O(n) bincount, no sort."""
    v = col[~np.isnan(col)]
    if not v.size:
        return np.zeros(cap, bool)
    iv = np.clip(v.astype(np.int64), 0, cap - 1)
    return np.bincount(iv, minlength=cap).astype(bool)


def compute_bin_mapper(
    X: np.ndarray,
    max_bin: int = 255,
    sample_count: int = 200_000,
    categorical_features: Optional[Sequence[int]] = None,
    seed: int = 0,
    has_nan: Optional[np.ndarray] = None,
    min_data_in_bin: int = 3,
    max_bin_by_feature: Optional[Sequence[int]] = None,
    cat_presence: Optional[np.ndarray] = None,
) -> BinMapper:
    """Driver-side boundary computation from a sample (the analog of
    LightGBMBase.getSampledRows + LGBM_DatasetCreateFromSampledColumn;
    binSampleCount param default 200000 — params/LightGBMParams.scala).

    ``has_nan`` overrides per-feature missing-ness when the caller has
    computed it on MORE data than ``X`` (the sparse path samples rows for
    boundaries but elects NaN bins from the full matrix). ``cat_presence``
    ((F, max_bin) bool) likewise overrides categorical bin occupancy, so the
    maxCatToOnehot decision never depends on the sampling seed."""
    X = np.asarray(X, dtype=np.float32)
    n, f = X.shape
    cat = np.zeros(f, dtype=bool)
    if categorical_features:
        cat[list(categorical_features)] = True
    # missing-ness decided on the FULL matrix (binning must route every NaN)
    if has_nan is None:
        has_nan = np.isnan(X).any(axis=0) & ~cat
    else:
        has_nan = np.asarray(has_nan, bool) & ~cat

    X_full = X
    if n > sample_count:
        rng = np.random.default_rng(seed)
        X = X[rng.choice(n, size=sample_count, replace=False)]

    bounds = np.full((f, max_bin - 1), np.inf, dtype=np.float32)
    nbins = np.zeros(f, dtype=np.int32)
    cat_counts = np.zeros(f, dtype=np.int32)
    caps = np.full(f, max_bin, np.int64)
    if max_bin_by_feature is not None:
        mb = np.asarray(max_bin_by_feature, np.int64)
        caps[: len(mb)] = np.clip(mb[:f], 2, max_bin)
    for j in range(f):
        if cat[j]:
            # identity bins capped at max_bin, plus one overflow bin; the
            # occupancy (and so cat_counts, which decides one-vs-rest) comes
            # from the FULL column, or from the caller's full-data bitmap
            pres = (np.asarray(cat_presence[j], bool)
                    if cat_presence is not None
                    else cat_presence_bitmap(X_full[:, j], max_bin))
            nz = np.flatnonzero(pres)
            hi = int(nz[-1]) if nz.size else 0
            nbins[j] = min(hi + 1, int(caps[j]) - 1) + 1
            cat_counts[j] = int(pres.sum())
            continue
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
    return BinMapper(boundaries=bounds, num_bins=nbins, is_categorical=cat,
                     max_bin=max_bin, has_nan=has_nan, cat_counts=cat_counts)


def _bin_dtype(mapper: BinMapper) -> torch.dtype:
    return torch.uint8 if mapper.max_bin <= 256 else torch.int32


def _identity_bins(x: torch.Tensor, max_bin: int,
                   limit: torch.Tensor) -> torch.Tensor:
    """Categorical bins of raw values ``x``: NaN → 0, clipped into
    [0, max_bin - 1] and truncated toward zero, then capped at ``limit``
    (each value's feature's num_bins - 1)."""
    ident = torch.clamp(torch.nan_to_num(x, nan=0.0), 0, max_bin - 1)
    return torch.minimum(ident.to(torch.int64), limit)


def apply_bins(mapper: BinMapper, X, device="cuda") -> torch.Tensor:
    """(N, F) raw floats → (N, F) bin ids on ``device`` (uint8 when
    max_bin <= 256, else int32). Non-NaN overflow clamps into the last REAL
    value bin; NaN goes to the feature's dedicated NaN bin when it has one;
    categorical features take identity bins (``_identity_bins``)."""
    from ..core.device import resolve_device

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
    cat = np.asarray(mapper.is_categorical, bool)
    if cat.any():
        cats = torch.as_tensor(cat).to(dev)
        ident = _identity_bins(X, mapper.max_bin, (num_bins - 1)[None, :])
        binned = torch.where(cats[None, :], ident, binned)
    return binned.to(_bin_dtype(mapper))


def _searchsorted_rows(bounds: torch.Tensor, rows: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """``searchsorted(bounds[rows[i]], x[i], side="left")`` for every entry
    ``i`` without gathering whole rows: one vectorised binary search, a
    gather of one boundary per entry per halving. NaN sorts after every
    boundary, as in ``torch.searchsorted``."""
    M = bounds.shape[1]
    lo = torch.zeros_like(rows)
    hi = torch.full_like(rows, M)
    flat = bounds.reshape(-1)
    base = rows * M
    x_nan = torch.isnan(x)
    for _ in range(M.bit_length()):
        live = lo < hi
        mid = (lo + hi) // 2
        v = flat[base + torch.clamp(mid, max=M - 1)]
        right = (v < x) | x_nan
        lo = torch.where(live & right, mid + 1, lo)
        hi = torch.where(live & ~right, mid, hi)
    return lo


class CsrBinner:
    """CSR chunk binning on the device with the mapper state uploaded ONCE
    (boundaries, limits, masks and the bins of an all-zero row are the same
    for every chunk). A chunk's (rows, F) bins start as a broadcast of the
    zero row's bins; only the explicit entries' bins are computed, each
    against its feature's boundaries, and scattered in. Each entry's bin is
    ``apply_bins``' for that value, so the result is bitwise the dense
    binning of the same rows."""

    def __init__(self, mapper: BinMapper, device="cuda"):
        from ..core.device import resolve_device

        dev = self.device = resolve_device(device)
        self.max_bin = mapper.max_bin
        self.dtype = _bin_dtype(mapper)
        self.zero = apply_bins(mapper, np.zeros((1, mapper.num_features),
                                                np.float32), dev)[0]
        self.boundaries = torch.as_tensor(
            np.asarray(mapper.boundaries, np.float32)).to(dev)
        self.nan_mask = torch.as_tensor(
            np.asarray(mapper.nan_mask, bool)).to(dev)
        num_bins = torch.as_tensor(
            np.asarray(mapper.num_bins, np.int64)).to(dev)
        self.nan_bin = num_bins - 1
        self.real_limit = self.nan_bin - self.nan_mask.to(torch.int64)
        self.is_cat = torch.as_tensor(
            np.asarray(mapper.is_categorical, bool)).to(dev)

    def __call__(self, data, rows, cols, n_rows: int) -> torch.Tensor:
        """(n_rows, F) bins of the chunk whose explicit entries are
        ``data`` at (``rows``, ``cols``), rows counted from the chunk's
        first."""
        dev = self.device
        data = torch.as_tensor(np.asarray(data, np.float32)).to(dev)
        rows = torch.as_tensor(np.asarray(rows, np.int64)).to(dev)
        cols = torch.as_tensor(np.asarray(cols, np.int64)).to(dev)
        b = _searchsorted_rows(self.boundaries, cols, data)
        b = torch.minimum(b, self.real_limit[cols])
        b = torch.where(torch.isnan(data) & self.nan_mask[cols],
                        self.nan_bin[cols], b)
        b = torch.where(self.is_cat[cols],
                        _identity_bins(data, self.max_bin,
                                       self.nan_bin[cols]), b)
        out = self.zero[None, :].expand(int(n_rows), -1).clone()
        out[rows, cols] = b.to(self.dtype)
        return out


def bin_csr_chunk(mapper: BinMapper, data, rows, cols, n_rows,
                  device="cuda") -> torch.Tensor:
    """One-shot convenience wrapper; loops should hold a :class:`CsrBinner`."""
    return CsrBinner(mapper, device)(data, rows, cols, n_rows)


class StreamingQuantileSketch:
    """One-pass bin boundaries for out-of-core ingest (``gbdt/stream.py``):
    feed row chunks through :meth:`update` / :meth:`update_csr`, then
    :meth:`finalize` into a :class:`BinMapper`.

    * **Exact regime**: while the stream holds at most ``sample_count``
      rows, every row is buffered and ``finalize()`` runs
      :func:`compute_bin_mapper` over all of them, so the boundaries are
      the resident path's byte for byte.
    * **Reservoir regime**: past ``sample_count`` rows the buffer is a
      seeded uniform row reservoir (algorithm R, vectorised per chunk; the
      ``numpy`` generator of ``seed``, so the draws are the JAX package's).
      A reservoir of m rows keeps every empirical quantile within
      sqrt(ln(2 / delta) / (2 m)) of the stream's with probability
      1 - delta (DKW): about 0.6 % of rank at m = 200k, delta = 1e-3.

    Missing values and categorical bin occupancy are tracked exactly over
    the whole stream and handed to :func:`compute_bin_mapper`, so neither
    the NaN bins nor the one-vs-rest decision depend on the reservoir."""

    def __init__(self, num_features: int, max_bin: int = 255,
                 sample_count: int = 200_000,
                 categorical_features: Optional[Sequence[int]] = None,
                 seed: int = 0, min_data_in_bin: int = 3,
                 max_bin_by_feature: Optional[Sequence[int]] = None):
        self.num_features = int(num_features)
        self.max_bin = int(max_bin)
        self.sample_count = int(sample_count)
        self.categorical_features = (list(categorical_features)
                                     if categorical_features else [])
        self.seed = int(seed)
        self.min_data_in_bin = int(min_data_in_bin)
        self.max_bin_by_feature = max_bin_by_feature
        self.rows_seen = 0
        self._buf = np.empty((min(self.sample_count, 4096), num_features),
                             np.float32)
        self._filled = 0
        self._overflowed = False
        self._rng = np.random.default_rng(self.seed)
        self._has_nan = np.zeros(num_features, bool)
        self._cat_pres = (np.zeros((num_features, self.max_bin), bool)
                          if self.categorical_features else None)

    def _reserve(self, extra: int) -> None:
        need = min(self._filled + extra, self.sample_count)
        if need > self._buf.shape[0]:
            cap = self._buf.shape[0]
            while cap < need:
                cap *= 2
            cap = min(cap, self.sample_count)
            self._buf = np.concatenate(
                [self._buf, np.empty((cap - self._buf.shape[0],
                                      self.num_features), np.float32)])

    def update(self, X: np.ndarray) -> "StreamingQuantileSketch":
        X = np.atleast_2d(np.asarray(X, np.float32))
        if X.shape[1] != self.num_features:
            raise ValueError(f"chunk has {X.shape[1]} features, sketch was "
                             f"built for {self.num_features}")
        c = X.shape[0]
        if c == 0:
            return self
        # exact whole-stream statistics, whatever the regime
        self._has_nan |= np.isnan(X).any(axis=0)
        if self._cat_pres is not None:
            for j in self.categorical_features:
                self._cat_pres[j] |= cat_presence_bitmap(X[:, j], self.max_bin)
        t0 = self.rows_seen
        self.rows_seen += c
        take_direct = min(c, self.sample_count - self._filled)
        if take_direct > 0:
            self._reserve(take_direct)
            self._buf[self._filled:self._filled + take_direct] = \
                X[:take_direct]
            self._filled += take_direct
        if take_direct < c:
            # algorithm R: the row at global index t replaces a uniform
            # slot with probability m / (t + 1)
            self._overflowed = True
            m = self.sample_count
            rest = X[take_direct:]
            t = t0 + take_direct + np.arange(rest.shape[0], dtype=np.int64)
            slot = (self._rng.random(rest.shape[0]) * (t + 1)).astype(
                np.int64)
            hit = np.flatnonzero(slot < m)
            # in row order, so a later row drawing the same slot wins
            for i in hit:
                self._buf[slot[i]] = rest[i]
        return self

    def update_csr(self, data, rows, cols, n_rows: int
                   ) -> "StreamingQuantileSketch":
        """A sparse chunk: densified on the host (implicit zeros are zeros,
        as :class:`CsrBinner` bins them) and fed to :meth:`update`; one
        chunk's rows, never the dataset's."""
        X = np.zeros((int(n_rows), self.num_features), np.float32)
        X[np.asarray(rows, np.int64), np.asarray(cols, np.int64)] = \
            np.asarray(data, np.float32)
        return self.update(X)

    @property
    def exact(self) -> bool:
        """True while ``finalize()`` equals ``compute_bin_mapper`` over the
        whole stream."""
        return not self._overflowed

    def finalize(self) -> BinMapper:
        if self.rows_seen == 0:
            raise ValueError("finalize() on an empty sketch: no rows seen")
        sample = self._buf[:self._filled]
        return compute_bin_mapper(
            sample, self.max_bin,
            # the buffer is the sample: never subsample it again
            sample_count=max(self._filled, 1),
            categorical_features=self.categorical_features or None,
            seed=self.seed, has_nan=self._has_nan,
            min_data_in_bin=self.min_data_in_bin,
            max_bin_by_feature=self.max_bin_by_feature,
            cat_presence=self._cat_pres)


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
