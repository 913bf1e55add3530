"""Pre-binned training data — the LightGBM ``Dataset`` concept on the card.

Counterpart of the JAX package's ``gbdt/dataset.py``. LightGBM separates
dataset construction (quantile binning, the expensive O(N·F·log B) pass)
from training; ``Dataset`` bins once on ``device`` at construction and keeps
the quantized (N, F) matrix resident there, so every
``train_booster(dataset, ...)`` call skips binning and the host→device copy
of the raw floats. Dense and scipy sparse (CSR) input, numeric and
categorical features; ``from_batches`` builds one from a stream of chunks,
binned as they arrive.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..ops.quantize import (BinMapper, CsrBinner, apply_bins,
                            cat_presence_bitmap, compute_bin_mapper)


def _is_sparse(X) -> bool:
    return hasattr(X, "tocsr") and hasattr(X, "nnz")


def sparse_bin_mapper(X_csr, max_bin: int, bin_sample_count: int,
                      categorical_features, seed: int,
                      min_data_in_bin: int = 3,
                      max_bin_by_feature=None) -> BinMapper:
    """The bin mapper of a scipy CSR matrix: boundaries from a sorted row
    sample of ``bin_sample_count`` rows, the NaN bins from every explicit
    entry (implicit zeros are never NaN) and each categorical column's
    occupancy from all its entries plus the implicit-zero bin, so neither
    depends on the sample."""
    n, f = X_csr.shape
    rng = np.random.default_rng(seed)
    take = (np.sort(rng.choice(n, size=bin_sample_count, replace=False))
            if n > bin_sample_count else np.arange(n))
    sample = np.asarray(X_csr[take].todense(), np.float32)
    nan_mask = np.isnan(X_csr.data)
    has_nan = np.zeros(f, bool)
    if nan_mask.any():
        has_nan[np.unique(X_csr.indices[nan_mask])] = True
    cat_presence = None
    if categorical_features:
        csc = X_csr.tocsc()
        cat_presence = np.zeros((f, max_bin), bool)
        for j in categorical_features:
            vals = csc.data[csc.indptr[j]: csc.indptr[j + 1]]
            cat_presence[j] = cat_presence_bitmap(vals, max_bin)
            if vals.size < n:          # at least one implicit zero
                cat_presence[j, 0] = True
    return compute_bin_mapper(sample, max_bin, bin_sample_count,
                              categorical_features, seed, has_nan=has_nan,
                              min_data_in_bin=min_data_in_bin,
                              max_bin_by_feature=max_bin_by_feature,
                              cat_presence=cat_presence)


def bin_sparse(X_csr, mapper: Optional[BinMapper], max_bin: int,
               bin_sample_count: int, categorical_features, seed: int,
               chunk_rows: int = 65_536, min_data_in_bin: int = 3,
               max_bin_by_feature=None, device=DEFAULT_DEVICE):
    """Bin a scipy CSR matrix chunk by chunk on ``device``; returns
    (mapper, (N, F) bins), the mapper ``sparse_bin_mapper``'s unless one
    is given. The bins are bitwise those of ``apply_bins`` on the dense
    rows."""
    X_csr = X_csr.tocsr()
    n = X_csr.shape[0]
    if mapper is None:
        mapper = sparse_bin_mapper(X_csr, max_bin, bin_sample_count,
                                   categorical_features, seed,
                                   min_data_in_bin, max_bin_by_feature)
    binner = CsrBinner(mapper, device)     # mapper state uploaded once
    chunks = []
    indptr = X_csr.indptr
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        s, e = int(indptr[lo]), int(indptr[hi])
        rows_local = np.repeat(np.arange(hi - lo, dtype=np.int64),
                               np.diff(indptr[lo:hi + 1]))
        chunks.append(binner(X_csr.data[s:e], rows_local,
                             X_csr.indices[s:e], hi - lo))
    return mapper, torch.cat(chunks, dim=0)


class Dataset:
    """Bins ``X`` once (resident on ``device``) for repeated training runs.

    Parameters mirror the binning-relevant subset of ``BoosterConfig``
    (max_bin / bin_sample_count / categorical_features / seed). ``label`` /
    ``weight`` / ``init_score`` / ``group_sizes`` ride along so a Dataset is
    a self-contained training input. ``X`` is a dense matrix or a scipy
    sparse one (binned through ``bin_sparse``; kept as CSR, densified only
    where raw rows are needed).
    """

    def __init__(
        self,
        X,
        label: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        init_score: Optional[np.ndarray] = None,
        group_sizes: Optional[np.ndarray] = None,
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
        self.device = resolve_device(device)
        if _is_sparse(X):
            X = X.tocsr()
            self.num_rows, self.num_features = X.shape
            if self.num_rows == 0:
                raise ValueError("Dataset requires a non-empty matrix")
            self.mapper, self.binned = bin_sparse(
                X, mapper, max_bin, bin_sample_count, categorical_features,
                seed, min_data_in_bin=min_data_in_bin,
                max_bin_by_feature=max_bin_by_feature, device=self.device)
            self._sparse = X if keep_raw else None
            self.X = None
        else:
            X = np.asarray(X, np.float32)
            if X.ndim != 2 or X.shape[0] == 0:
                raise ValueError(
                    f"Dataset requires a non-empty 2-D matrix, got {X.shape}")
            self.num_rows, self.num_features = X.shape
            self.mapper = mapper if mapper is not None else compute_bin_mapper(
                X, max_bin, bin_sample_count, categorical_features, seed,
                min_data_in_bin=min_data_in_bin,
                max_bin_by_feature=max_bin_by_feature)
            self.binned = apply_bins(self.mapper, X, self.device)
            self._sparse = None
            # raw floats kept host-side for callers that want them back;
            # drop with keep_raw=False to halve host memory
            self.X = X if keep_raw else None
        self.label = None if label is None else np.asarray(label, np.float32)
        self.weight = None if weight is None else np.asarray(weight, np.float32)
        self.init_score = init_score
        self.group_sizes = group_sizes
        self.categorical_features = categorical_features

    @classmethod
    def from_batches(cls, batches, categorical_features=None,
                     max_bin: int = 255, bin_sample_count: int = 200_000,
                     seed: int = 0, mapper: Optional[BinMapper] = None,
                     min_data_in_bin: int = 3, max_bin_by_feature=None,
                     device=DEFAULT_DEVICE) -> "Dataset":
        """Bounded-memory construction from an iterator of chunks, each
        ``X``, ``(X, y)`` or ``(X, y, w)``: every chunk is binned on
        ``device`` as it arrives and only its bins are kept (on the host
        until the end, then moved to ``device`` once), so the raw floats
        never sit whole in memory.

        Without ``mapper`` the boundaries come from the first
        ``bin_sample_count`` rows (a prefix sample: right for a shuffled
        stream; pass a mapper for an ordered one), and the rows before that
        point wait raw until the mapper exists. A NaN in a feature that the
        mapper gave no missing bin raises instead of falling into a value
        bin. Ranking groups and init scores are not streamed: build those
        datasets whole."""
        dev = resolve_device(device)
        user_mapper = mapper is not None
        binned_parts: list = []
        y_parts: list = []
        w_parts: list = []
        raw_buf: list = []                  # raw chunks before the mapper
        buffered = 0
        nan_seen = None                     # per feature, over every chunk

        def _bin(Xb):
            binned_parts.append(apply_bins(mapper, Xb, dev).cpu().numpy())

        def _flush_raw():
            nonlocal buffered
            for Xb in raw_buf:
                _bin(Xb)
            raw_buf.clear()
            buffered = 0

        for batch in batches:
            if isinstance(batch, tuple):
                Xc, yc, wc = (batch + (None, None))[:3]
            else:
                Xc, yc, wc = batch, None, None
            Xc = np.asarray(Xc, np.float32)
            if Xc.ndim != 2:
                raise ValueError(f"chunk must be 2-D, got {Xc.shape}")
            chunk_nan = np.isnan(Xc).any(axis=0)
            nan_seen = (chunk_nan if nan_seen is None
                        else (nan_seen | chunk_nan))
            if yc is not None:
                y_parts.append(np.asarray(yc, np.float32))
            if wc is not None:
                w_parts.append(np.asarray(wc, np.float32))
            if mapper is None:
                raw_buf.append(Xc)
                buffered += len(Xc)
                if buffered >= bin_sample_count:
                    sample = np.concatenate(raw_buf)[:bin_sample_count]
                    mapper = compute_bin_mapper(
                        sample, max_bin, bin_sample_count,
                        categorical_features, seed,
                        min_data_in_bin=min_data_in_bin,
                        max_bin_by_feature=max_bin_by_feature)
                    _flush_raw()
            else:
                _bin(Xc)
        if mapper is None:
            if not raw_buf:
                raise ValueError("from_batches got an empty batch iterator")
            mapper = compute_bin_mapper(
                np.concatenate(raw_buf), max_bin, bin_sample_count,
                categorical_features, seed, min_data_in_bin=min_data_in_bin,
                max_bin_by_feature=max_bin_by_feature)
            _flush_raw()
        if not binned_parts:
            raise ValueError("from_batches got an empty batch iterator")
        # a NaN the mapper has no missing bin for would land in the last
        # value bin: another model than Dataset(X) on the same rows
        late_nan = nan_seen & ~mapper.nan_mask & ~mapper.is_categorical
        if late_nan.any():
            raise ValueError(
                f"features {np.flatnonzero(late_nan).tolist()} contain NaN "
                "but the streamed sample that fixed the bin boundaries had "
                "none: sample the whole stream or pass a mapper with "
                "has_nan set")
        binned = np.concatenate(binned_parts)
        del binned_parts[:]
        ds = cls.__new__(cls)
        ds.device = dev
        ds._user_mapper = user_mapper
        ds._sparse = None
        ds.X = None                          # the raw floats were not kept
        ds.num_rows, ds.num_features = binned.shape
        ds.mapper = mapper
        ds.binned = torch.from_numpy(binned).to(dev)
        ds.label = np.concatenate(y_parts) if y_parts else None
        ds.weight = np.concatenate(w_parts) if w_parts else None
        ds.init_score = None
        ds.group_sizes = None
        ds.categorical_features = categorical_features
        return ds

    @property
    def shape(self):
        return (self.num_rows, self.num_features)

    def block_until_ready(self) -> "Dataset":
        """Wait for the device's binning work to finish."""
        if self.binned.is_cuda:
            torch.cuda.synchronize(self.binned.device)
        return self

    def raw_dense(self) -> Optional[np.ndarray]:
        """Dense raw rows (warm starts and binning under another mapper
        need them); a kept sparse matrix is densified on demand."""
        if self.X is not None:
            return self.X
        if self._sparse is not None:
            return np.asarray(self._sparse.todense(), np.float32)
        return None
