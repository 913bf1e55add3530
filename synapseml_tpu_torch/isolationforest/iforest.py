"""Isolation forest: array-encoded trees, grown on the host, scored on the
device.

Algorithm per Liu/Ting/Zhou: each tree isolates a subsample by random
(feature, split) choices to depth ceil(log2(maxSamples)); the anomaly score is
``2^(−E[pathLength]/c(n))``. Params mirror the LinkedIn estimator the reference
wraps (isolationforest/IsolationForest.scala:17-72): numEstimators, maxSamples,
maxFeatures, contamination, bootstrap, randomSeed, featuresCol, scoreCol,
predictionCol, plus the port's ``device``.

Growth is host numpy driven by one ``np.random.default_rng(randomSeed)``:
the rows, then the features of each tree, then each node's feature and
split, so the forest arrays ``feat``, ``thresh``, ``left`` and ``plen``
equal the JAX package's. Scoring walks all rows through all trees at once:
``max_depth + 1`` rounds of gathers over a ``[rows, T]`` node-index tensor
(leaves loop back to themselves), the mean path over trees taken in float32
on the device, then ``2^(−mean / c(sub))`` in float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.params import Param, HasFeaturesCol, HasPredictionCol
from ..core.pipeline import Estimator, Model
from ..core.table import Table, feature_matrix

# the forest's four [T, max_nodes] arrays, in the order the walk takes them
FOREST_ARRAYS = ("feat", "thresh", "left", "plen")
# rows scored per walk: the walk's [rows, T] int64 node indices and gathers
# take about 40 bytes per (row, tree); 2**20 rows x 100 trees is ~4 GiB
_ROWS_PER_WALK = 1 << 20


def _c(n: float) -> float:
    """Average BST unsuccessful-search path length (normalizer)."""
    if n <= 1:
        return 0.0
    return 2.0 * (np.log(n - 1.0) + 0.5772156649) - 2.0 * (n - 1.0) / n


class _IForestParams(HasFeaturesCol, HasPredictionCol):
    numEstimators = Param("numEstimators", "Number of trees", int, 100)
    maxSamples = Param("maxSamples", "Subsample size per tree (<=1.0 means "
                       "fraction of rows)", float, 256.0)
    maxFeatures = Param("maxFeatures", "Fraction (or count) of features per tree",
                        float, 1.0)
    contamination = Param("contamination", "Expected outlier fraction; 0 means "
                          "no label thresholding", float, 0.0)
    contaminationError = Param("contaminationError",
                               "Tolerated error on contamination (unused on "
                               "exact quantiles; kept for API parity)", float, 0.0)
    bootstrap = Param("bootstrap", "Sample with replacement", bool, False)
    randomSeed = Param("randomSeed", "Seed", int, 1)
    scoreCol = Param("scoreCol", "Output column for anomaly score", str,
                     "outlierScore")
    device = Param("device", "Device that scores the forest: 'cuda' "
                   "(default) or 'cpu'", str, DEFAULT_DEVICE)


class IsolationForest(Estimator, _IForestParams):
    def _fit(self, df: Table) -> "IsolationForestModel":
        dev = resolve_device(self.getDevice())
        X = _matrix(df, self.getFeaturesCol())
        n, d = X.shape
        if n == 0:
            raise ValueError("IsolationForest: empty dataset")
        rng = np.random.default_rng(self.getRandomSeed())

        ms = self.getMaxSamples()
        sub = int(round(ms * n)) if ms <= 1.0 else int(ms)
        sub = max(2, min(sub, n))
        mf = self.getMaxFeatures()
        n_feat = int(round(mf * d)) if mf <= 1.0 else int(mf)
        n_feat = max(1, min(n_feat, d))
        max_depth = int(np.ceil(np.log2(sub)))
        max_nodes = 2 ** (max_depth + 1) - 1
        T = self.getNumEstimators()

        feat = np.zeros((T, max_nodes), dtype=np.int32)
        thresh = np.zeros((T, max_nodes), dtype=np.float32)
        left = np.zeros((T, max_nodes), dtype=np.int32)  # right = left+1; 0 = leaf
        plen = np.zeros((T, max_nodes), dtype=np.float32)

        for t in range(T):
            rows = (rng.integers(0, n, size=sub) if self.getBootstrap()
                    else rng.permutation(n)[:sub])
            feats = rng.permutation(d)[:n_feat]
            _grow(X[rows][:, feats], feats, rng, max_depth,
                  feat[t], thresh[t], left[t], plen[t])

        forest = {"feat": feat, "thresh": thresh, "left": left, "plen": plen,
                  "subSize": sub, "threshold": None}
        scores = _score(X, device_forest(forest, dev), sub)
        if self.getContamination() > 0:
            forest["threshold"] = float(
                np.quantile(scores, 1.0 - self.getContamination()))
        return IsolationForestModel(
            forest=forest, **{p: self.get(p) for p in self._paramMap})


class IsolationForestModel(Model, _IForestParams):
    forest = Param("forest", "Array-encoded forest + score threshold",
                   is_complex=True)

    def _device_forest(self) -> tuple:
        """The forest's arrays on the model's device, uploaded once per
        forest and device."""
        f = self.get("forest")
        dev = resolve_device(self.getDevice())
        cached = getattr(self, "_forest_cache", None)
        if cached is not None and cached[0] is f and cached[1] == dev:
            return cached[2]
        arrays = device_forest(f, dev)
        self._forest_cache = (f, dev, arrays)
        return arrays

    def _transform(self, df: Table) -> Table:
        f = self.get("forest")
        scores = _score(_matrix(df, self.getFeaturesCol()),
                        self._device_forest(), f["subSize"])
        out = df.with_column(self.getScoreCol(), scores.astype(np.float64))
        thr = f.get("threshold")
        label = (scores >= thr) if thr is not None else np.zeros(len(scores), bool)
        return out.with_column(self.getPredictionCol(), label.astype(np.float64))

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_forest_cache", None)   # device tensors stay in-process
        return state


def _grow(Xs: np.ndarray, feats: np.ndarray, rng, max_depth: int,
          feat: np.ndarray, thresh: np.ndarray, left: np.ndarray,
          plen: np.ndarray) -> None:
    """Grow one tree into the preallocated arrays (host-side, subsample-sized)."""
    next_free = [1]

    def build(node: int, idx: np.ndarray, depth: int) -> None:
        n_here = idx.size
        lo = Xs[idx].min(axis=0) if n_here else None
        hi = Xs[idx].max(axis=0) if n_here else None
        if depth >= max_depth or n_here <= 1 or lo is None or (lo == hi).all():
            left[node] = 0  # leaf
            plen[node] = depth + _c(max(n_here, 1))
            return
        # random feature among those that still vary
        varying = np.flatnonzero(hi > lo)
        j = int(varying[rng.integers(0, varying.size)])
        s = float(rng.uniform(lo[j], hi[j]))
        feat[node] = feats[j]
        thresh[node] = s
        l = next_free[0]
        next_free[0] += 2
        left[node] = l
        go_left = Xs[idx, j] < s
        build(l, idx[go_left], depth + 1)
        build(l + 1, idx[~go_left], depth + 1)

    build(0, np.arange(Xs.shape[0]), 0)


def device_forest(forest: dict, device) -> tuple:
    """``(feat, thresh, left, plen)`` of a forest dict as tensors on
    ``device``, flattened over trees ([T * max_nodes]; node ``j`` of tree
    ``t`` at ``t * max_nodes + j``), the indices int64 for the gathers."""
    dev = resolve_device(device)
    feat, thresh, left, plen = (np.require(forest[k], requirements="W")
                                for k in FOREST_ARRAYS)
    T, nodes = feat.shape
    return (torch.as_tensor(feat.reshape(-1), device=dev).long(),
            torch.as_tensor(thresh.reshape(-1), device=dev),
            torch.as_tensor(left.reshape(-1), device=dev).long(),
            torch.as_tensor(plen.reshape(-1), device=dev),
            T, nodes)


def mean_path(x: torch.Tensor, forest: tuple, max_depth: int) -> torch.Tensor:
    """Mean path length over the trees (float32, [rows]) of the rows of
    ``x`` ([rows, d] float32 on the forest's device): every (row, tree)
    pair advances one level per step of ``max_depth + 1`` (a leaf,
    ``left == 0``, keeps its node)."""
    feat, thresh, left, plen, T, nodes = forest
    base = torch.arange(T, device=x.device) * nodes        # tree t's node 0
    cur = base.expand(x.shape[0], T).clone()               # [rows, T] flat
    for _ in range(max_depth + 1):
        f = feat[cur]
        lf = left[cur]
        xv = torch.gather(x, 1, f)                         # row's value of f
        child = torch.where(xv < thresh[cur], lf, lf + 1) + base
        cur = torch.where(lf == 0, cur, child)
    return plen[cur].mean(dim=1)


def _score(X: np.ndarray, forest: tuple, sub_size: int) -> np.ndarray:
    """Anomaly scores (float64 on the host) of the rows of ``X`` through a
    ``device_forest``: the walk on its device in chunks of
    ``_ROWS_PER_WALK`` rows, then ``2^(−mean / c(sub))`` in float64."""
    max_depth = int(np.ceil(np.log2(sub_size)))
    dev = forest[0].device
    X = np.asarray(X, dtype=np.float32)
    means = []
    with torch.no_grad():
        for start in range(0, X.shape[0], _ROWS_PER_WALK):
            x = torch.as_tensor(X[start:start + _ROWS_PER_WALK], device=dev)
            means.append(mean_path(x, forest, max_depth).cpu().numpy())
    mean = (np.concatenate(means) if means
            else np.zeros(0, np.float32))
    return np.exp2(-mean / _c(float(sub_size)))


def _matrix(df: Table, col: str) -> np.ndarray:
    X = feature_matrix(df, col)
    if X.ndim != 2:
        raise ValueError(f"features column {col!r} must be 2-D vectors")
    return X
