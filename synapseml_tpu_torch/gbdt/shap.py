"""TreeSHAP feature contributions, host-side in numpy.

The JAX package's ``gbdt/shap.py`` (the polynomial-time TreeSHAP recursion
of Lundberg & Lee, "Consistent Individualized Feature Attribution for Tree
Ensembles") with one change: the recursion walks each tree once for a block
of rows instead of once per row. The path's features and zero fractions
depend only on the tree; each row's one fractions and path weights ride as
vectors (``_Path.one`` and ``_Path.w`` are (capacity, rows)). At every node
both children are visited for every row, the child a row's prediction takes
with one fraction ``io`` and the other with 0, so each row does the scalar
recursion's arithmetic in the same order; only the order in which the two
subtrees' contributions add into a row's ``phi`` differs.

Returns (N, F+1), per-feature contributions plus the expected value in the
last column, or (N, K*(F+1)) per-class blocks for multiclass: LightGBM's
``predict(pred_contrib=True)`` layout.
"""

from __future__ import annotations

import numpy as np

ROWS_PER_BLOCK = 4096


class _Path:
    """Decomposed path state: features and zero fractions per element,
    one fractions and weights per (element, row)."""

    __slots__ = ("feat", "zero", "one", "w")

    def __init__(self, capacity: int, n: int):
        self.feat = np.full(capacity, -1, np.int64)
        self.zero = np.zeros(capacity)
        self.one = np.zeros((capacity, n))
        self.w = np.zeros((capacity, n))

    def copy(self) -> "_Path":
        p = _Path.__new__(_Path)
        p.feat, p.zero = self.feat.copy(), self.zero.copy()
        p.one, p.w = self.one.copy(), self.w.copy()
        return p


def _extend(p: _Path, depth: int, pz: float, po: np.ndarray, pi: int) -> None:
    p.feat[depth] = pi
    p.zero[depth] = pz
    p.one[depth] = po
    p.w[depth] = 1.0 if depth == 0 else 0.0
    for i in range(depth - 1, -1, -1):
        p.w[i + 1] += po * p.w[i] * (i + 1) / (depth + 1)
        p.w[i] = pz * p.w[i] * (depth - i) / (depth + 1)


def _unwind(p: _Path, depth: int, idx: int) -> None:
    one, zero = p.one[idx], p.zero[idx]
    hot = one != 0
    safe = np.where(hot, one, 1.0)
    nxt = p.w[depth].copy()
    for i in range(depth - 1, -1, -1):
        tmp = p.w[i]
        w_hot = nxt * (depth + 1) / ((i + 1) * safe)
        nxt = np.where(hot, tmp - w_hot * zero * (depth - i) / (depth + 1),
                       nxt)
        p.w[i] = np.where(hot, w_hot, tmp * (depth + 1) / (zero * (depth - i)))
    p.feat[idx:depth] = p.feat[idx + 1:depth + 1]
    p.zero[idx:depth] = p.zero[idx + 1:depth + 1]
    p.one[idx:depth] = p.one[idx + 1:depth + 1]


def _unwound_sum(p: _Path, depth: int, idx: int) -> np.ndarray:
    one, zero = p.one[idx], p.zero[idx]
    hot = one != 0
    safe = np.where(hot, one, 1.0)
    nxt = p.w[depth]
    total = np.zeros_like(nxt)
    for i in range(depth - 1, -1, -1):
        tmp = nxt * (depth + 1) / ((i + 1) * safe)
        total = total + np.where(hot, tmp,
                                 p.w[i] * (depth + 1) / (zero * (depth - i)))
        nxt = np.where(hot, p.w[i] - tmp * zero * (depth - i) / (depth + 1),
                       nxt)
    return total


def _goes_left(tree, X: np.ndarray, node: int) -> np.ndarray:
    """(rows,) bool: the rows the prediction path sends left at ``node``,
    with LightGBM's missing routing (``grower._descend``'s semantics)."""
    f = int(tree["sf"][node])
    mt = int(tree["mt"][node])
    xv = X[:, f]
    isnan = np.isnan(xv)
    if tree["stype"][node] == 1:
        # NaN -> 0 unless mt=nan (-1 there), then clip into [-1, last
        # tracked bit] and truncate, as the prediction path does
        cf = np.where(isnan, 0.0 if mt != 2 else -1.0, xv)
        c = np.clip(cf, -1, tree["bits"].shape[1] * 32 - 1).astype(np.int64)
        cw = np.maximum(c, 0)
        word = tree["bits"][node][cw >> 5].astype(np.int64)
        return (c >= 0) & (((word >> (cw & 31)) & 1) == 1)
    if mt != 2:
        xv = np.where(isnan, 0.0, xv)           # NaN coerces unless mt=nan
    missing = ((np.abs(xv) <= 1e-35) if mt == 1
               else (isnan if mt == 2 else np.zeros(len(xv), bool)))
    with np.errstate(invalid="ignore"):
        return np.where(missing, bool(tree["dleft"][node]),
                        xv <= tree["thr"][node])


def _shap_recurse(tree, X, phi, node, depth, path: _Path, pz, po, pi):
    path = path.copy()
    _extend(path, depth, pz, po, pi)
    if node < 0:  # leaf
        leaf_val = tree["lv"][~node]
        for i in range(1, depth + 1):
            w = _unwound_sum(path, depth, i)
            phi[:, path.feat[i]] += w * (path.one[i] - path.zero[i]) * leaf_val
        return
    f = int(tree["sf"][node])
    left = _goes_left(tree, X, node)

    def cover(nd):
        return tree["leaf_cover"][~nd] if nd < 0 else tree["cover"][nd]

    iz, io = 1.0, np.ones(X.shape[0])
    found = -1
    for i in range(1, depth + 1):
        if path.feat[i] == f:
            found = i
            break
    if found >= 0:
        iz, io = path.zero[found], path.one[found].copy()
        _unwind(path, depth, found)
        depth -= 1
    lc, rc = tree["lc"][node], tree["rc"][node]
    lz = cover(lc) / tree["cover"][node]
    rz = cover(rc) / tree["cover"][node]
    _shap_recurse(tree, X, phi, lc, depth + 1, path, iz * lz,
                  np.where(left, io, 0.0), f)
    _shap_recurse(tree, X, phi, rc, depth + 1, path, iz * rz,
                  np.where(left, 0.0, io), f)


def forest_shap(booster, X: np.ndarray) -> np.ndarray:
    """(N, F+1) contributions, or (N, K*(F+1)) for multiclass: per-class
    blocks of [per-feature..., expected_value]. Honors the config's
    ``start_iteration`` prediction window."""
    n, nfeat = X.shape
    k = booster.models_per_iter
    out = np.zeros((n, k, nfeat + 1), np.float64)
    out[:, :, -1] += booster.base_score[None, :k]

    start = max(int(getattr(booster.config, "start_iteration", 0)), 0) * k
    weights = np.asarray(booster.tree_weights, np.float64)
    if booster.average_output:
        weights = weights / max((len(booster.trees) - start) // k, 1)
    Xd = np.asarray(X, np.float32).astype(np.float64)

    for ti, t in enumerate(booster.trees):
        if ti < start:
            continue        # pred_contrib honors the prediction window
        cls = ti % k
        ns = int(t.num_splits)
        nleaves = ns + 1
        lv = np.asarray(t.leaf_value, np.float64)[:nleaves] * weights[ti]
        if ns == 0:
            out[:, cls, -1] += lv[0]
            continue
        leaf_cover = np.maximum(np.asarray(t.leaf_count, np.float64)[:nleaves],
                                1.0)
        tree = {
            "sf": np.asarray(t.split_feature)[:ns],
            "thr": booster._thresholds(ti)[:ns].astype(np.float64),
            "lc": np.asarray(t.left_child)[:ns],
            "rc": np.asarray(t.right_child)[:ns],
            "lv": lv,
            "cover": np.maximum(np.asarray(t.internal_count,
                                           np.float64)[:ns], 1.0),
            "leaf_cover": leaf_cover,
            "stype": np.asarray(t.split_type)[:ns],
            "bits": np.asarray(t.cat_bitset)[:ns],
            "dleft": np.asarray(t.default_left)[:ns],
            "mt": booster._missing_types(ti)[:ns],
        }
        ev = float((lv * leaf_cover).sum() / leaf_cover.sum())
        out[:, cls, -1] += ev
        cap = ns + 3
        for s in range(0, n, ROWS_PER_BLOCK):
            Xb = Xd[s:s + ROWS_PER_BLOCK]
            m = Xb.shape[0]
            phi = np.zeros((m, nfeat + 1))
            _shap_recurse(tree, Xb, phi, 0, 0, _Path(cap, m), 1.0,
                          np.ones(m), -1)
            out[s:s + m, cls, :nfeat] += phi[:, :nfeat]
    return out[:, 0, :] if k == 1 else out.reshape(n, k * (nfeat + 1))
