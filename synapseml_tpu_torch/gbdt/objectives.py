"""Boosting objectives: gradients/hessians, init scores, and eval metrics.

Counterpart of the JAX package's ``gbdt/objectives.py``, with its names:
binary, multiclass (softmax) and multiclassova, the regression family
(regression, regression_l1, huber, fair, poisson, quantile, mape, gamma,
tweedie, cross_entropy), lambdarank, ``get_objective`` with the aliases, and
the eval metrics. Each objective is a function of (score, label, weight)
tensors on one device; a multiclass score is ``(N, K)``.

Scores are raw margins; ``init_score`` implements boost_from_average.

LambdaRank computes the JAX package's padded pair-matrix function over
chunks of queries: queries are bucketed by group size and a chunk holds as
many as keep ``queries * width**2`` within a pair budget, so the ``(Q, G,
G)`` pair tensors never exist for the whole table at once (at
MSLR-WEB10K's shape they would take about 32 GB each in float32).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

# pairs (queries x width x width) of one lambdarank chunk: about 28 bytes
# of float32/bool temporaries per pair, so ~1 GB per chunk
PAIR_BUDGET = 1 << 25


class Objective(NamedTuple):
    name: str
    num_model_per_iteration: int                    # K for multiclass, else 1
    grad_hess: Callable                             # (score, label, weight) -> (g, h)
    init_score: Callable                            # (label, weight) -> 0-d or (K,) tensor
    transform: Callable                             # raw score -> prediction space


def _average(y, w):
    return (y * w).sum() / w.sum()


def _sigmoid_out(x: torch.Tensor) -> torch.Tensor:
    """The output transform's sigmoid: computed in float64 and rounded to
    float32, so equal raw scores give equal probabilities wherever they sit
    in the tensor (torch's CPU kernel takes another route for the tail of
    its vector loop, an ulp away, and an ulp splits a tie of raw scores
    that AUC counts as one)."""
    return torch.sigmoid(x.to(torch.float64)).to(torch.float32)


def binary_objective(sigmoid: float = 1.0) -> Objective:
    s = sigmoid

    def gh(score, y, w):
        p = torch.sigmoid(s * score)
        g = s * (p - y)
        h = s * s * p * (1.0 - p)
        return g * w, torch.clamp_min(h * w, 1e-16)

    def init(y, w):
        p = torch.clamp(_average(y, w), 1e-12, 1 - 1e-12)
        return torch.log(p / (1 - p)) / s

    return Objective("binary", 1, gh, init, lambda sc: _sigmoid_out(s * sc))


def _class_counts(y, w, num_class: int):
    counts = torch.zeros(num_class, dtype=torch.float32, device=y.device)
    return counts.index_add_(0, y.to(torch.int64), w.to(torch.float32))


def _one_hot(y, num_class: int):
    return torch.nn.functional.one_hot(y.to(torch.int64),
                                       num_class).to(torch.float32)


def multiclass_objective(num_class: int) -> Objective:
    def gh(score, y, w):  # score (N, K), y (N,) class ids
        p = torch.softmax(score, dim=-1)
        onehot = _one_hot(y, num_class)
        g = (p - onehot) * w[:, None]
        h = 2.0 * p * (1.0 - p) * w[:, None]   # LightGBM's factor-2 softmax hessian
        return g, torch.clamp_min(h, 1e-16)

    def init(y, w):
        counts = _class_counts(y, w, num_class)
        # all-zero weights would make this 0/0 -> NaN before the clip
        p = torch.clamp(counts / torch.clamp_min(counts.sum(), 1e-12),
                        1e-12, 1.0)
        return torch.log(p)

    return Objective("multiclass", num_class, gh, init,
                     lambda sc: torch.softmax(sc, dim=-1))


def multiclassova_objective(num_class: int, sigmoid: float = 1.0) -> Objective:
    s = sigmoid

    def gh(score, y, w):
        onehot = _one_hot(y, num_class)
        p = torch.sigmoid(s * score)
        g = s * (p - onehot) * w[:, None]
        h = s * s * p * (1 - p) * w[:, None]
        return g, torch.clamp_min(h, 1e-16)

    def init(y, w):
        counts = _class_counts(y, w, num_class)
        p = torch.clamp(counts / torch.clamp_min(counts.sum(), 1e-12),
                        1e-12, 1 - 1e-12)
        return torch.log(p / (1 - p)) / s

    # LightGBM MulticlassOVA::ConvertOutput: per-class sigmoid, no
    # normalization (each class is an independent binary problem)
    return Objective("multiclassova", num_class, gh, init,
                     lambda sc: _sigmoid_out(s * sc))


def regression_objective() -> Objective:
    def gh(score, y, w):
        return (score - y) * w, w

    return Objective("regression", 1, gh, _average, lambda sc: sc)


def _weighted_quantile(y, w, alpha):
    """Interpolating weighted quantile, ``torch.quantile``'s linear
    interpolation when weights are uniform; rows with w == 0 are excluded
    exactly. LightGBM's WeightedPercentileFun interpolates the same way."""
    n = y.shape[0]
    pos = w > 0
    m = torch.clamp_min(pos.sum(), 1)
    yy = torch.where(pos, y, torch.inf)      # zero-weight rows sort last
    order = torch.argsort(yy, stable=True)
    ys = yy[order]
    ws = w[order]
    before = torch.cumsum(ws, 0) - ws        # weight strictly before each row
    total = ws.sum()
    r = alpha * (total - total / m)          # uniform w: alpha * (n - 1)
    j = torch.clamp(torch.searchsorted(before, r.reshape(1),
                                       side="right")[0] - 1, 0, n - 1)
    jn = torch.clamp(j + 1, 0, n - 1)
    frac = torch.clamp((r - before[j]) / torch.clamp_min(ws[j], 1e-38),
                       0.0, 1.0)
    # interpolate toward ys[jn] only when it is a real row: inside the LAST
    # positive-weight row's span the partner is the inf tail, and the init
    # score would become inf
    nxt = torch.where(torch.isfinite(ys[jn]) & (frac > 0), ys[jn], ys[j])
    return ys[j] + frac * (nxt - ys[j])


def regression_l1_objective() -> Objective:
    def gh(score, y, w):
        return torch.sign(score - y) * w, w  # LightGBM uses hessian=weight for L1

    return Objective("regression_l1", 1, gh,
                     lambda y, w: _weighted_quantile(y, w, 0.5),
                     lambda sc: sc)


def huber_objective(alpha: float = 0.9) -> Objective:
    def gh(score, y, w):
        d = score - y
        g = torch.where(torch.abs(d) <= alpha, d, alpha * torch.sign(d))
        return g * w, w

    return Objective("huber", 1, gh, _average, lambda sc: sc)


def fair_objective(c: float = 1.0) -> Objective:
    def gh(score, y, w):
        d = score - y
        g = c * d / (torch.abs(d) + c)
        h = c * c / (torch.abs(d) + c) ** 2
        return g * w, torch.clamp_min(h * w, 1e-16)

    return Objective("fair", 1, gh, _average, lambda sc: sc)


def _log_average(y, w):
    return torch.log(torch.clamp_min(_average(y, w), 1e-12))


def poisson_objective(max_delta_step: float = 0.7) -> Objective:
    # exp(max_delta_step) rounded to float32, as the reference takes it
    step = float(np.exp(np.float32(max_delta_step)).astype(np.float32))

    def gh(score, y, w):
        ex = torch.exp(score)
        return (ex - y) * w, torch.clamp_min(ex * step * w, 1e-16)

    return Objective("poisson", 1, gh, _log_average, torch.exp)


def quantile_objective(alpha: float = 0.5) -> Objective:
    def gh(score, y, w):
        d = score - y
        g = torch.where(d >= 0, 1.0 - alpha, -alpha)
        return g * w, w

    return Objective("quantile", 1, gh,
                     lambda y, w: _weighted_quantile(y, w, alpha),
                     lambda sc: sc)


def mape_objective() -> Objective:
    def gh(score, y, w):
        scale = 1.0 / torch.clamp_min(torch.abs(y), 1.0)
        return torch.sign(score - y) * scale * w, scale * w

    return Objective("mape", 1, gh,
                     lambda y, w: _weighted_quantile(y, w, 0.5),
                     lambda sc: sc)


def cross_entropy_objective() -> Objective:
    """LightGBM cross_entropy (aka xentropy): binary log-loss with
    continuous labels in [0, 1]; the math of ``binary_objective`` at
    sigmoid=1 (which never assumes y in {0, 1})."""
    return binary_objective(1.0)._replace(name="cross_entropy")


def gamma_objective() -> Objective:
    def gh(score, y, w):
        ey = y * torch.exp(-score)
        return (1.0 - ey) * w, torch.clamp_min(ey * w, 1e-16)

    return Objective("gamma", 1, gh, _log_average, torch.exp)


def tweedie_objective(rho: float = 1.5) -> Objective:
    def gh(score, y, w):
        a = -y * torch.exp((1.0 - rho) * score)
        b = torch.exp((2.0 - rho) * score)
        g = a + b
        h = a * (1.0 - rho) + b * (2.0 - rho)
        return g * w, torch.clamp_min(h * w, 1e-16)

    return Objective("tweedie", 1, gh, _log_average, torch.exp)


# ---------------------------------------------------------------------------
# LambdaRank (grouped, padded pair matrices over chunks of queries)
# ---------------------------------------------------------------------------

def make_grouped(labels: np.ndarray, group_sizes: np.ndarray,
                 max_group: Optional[int] = None) -> np.ndarray:
    """Host-side: rows must already be group-contiguous (the analog of the
    reference's repartition-by-group). Returns the padded row-index matrix
    (Q, Gmax) with -1 padding."""
    sizes = np.asarray(group_sizes, np.int64)
    gmax = int(max_group or sizes.max())
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    col = np.arange(gmax)[None, :]
    return np.where(col < np.minimum(sizes, gmax)[:, None],
                    starts[:, None] + col, -1).astype(np.int64)


def _label_gain(rel, label_gain=None):
    """Relevance → gain: LightGBM's label_gain table when provided (entry i
    is the gain for label i), else the default 2^rel - 1."""
    if label_gain:
        table = torch.as_tensor(label_gain, dtype=torch.float32,
                                device=rel.device)
        idx = torch.clamp(rel.to(torch.int64), 0, len(label_gain) - 1)
        return table[idx]
    return 2.0 ** rel - 1.0


def query_chunks(group_index, pair_budget: int) -> List[np.ndarray]:
    """Buckets the rows of ``group_index`` (Q, Gmax) by group size: queries
    sorted by size, each chunk as many consecutive ones as keep
    ``len(chunk) * widest**2`` within ``pair_budget`` (one query at least).
    Returns each chunk's (q, width) row-index matrix, -1 padded."""
    gi = np.asarray(group_index)
    sizes = (gi >= 0).sum(axis=1)
    order = np.argsort(sizes, kind="stable")
    chunks, start = [], 0
    while start < len(order):
        end = start + 1
        while end < len(order) and \
                (end + 1 - start) * int(sizes[order[end]]) ** 2 <= pair_budget:
            end += 1
        width = max(int(sizes[order[end - 1]]), 1)
        chunks.append(gi[order[start:end], :width])
        start = end
    return chunks


def _lambdarank_chunk(score, y, gi, sigmoid, truncation, label_gain):
    """(g, h) of every item of one chunk's (q, G) row-index matrix: the JAX
    package's pair-matrix formulation on this chunk alone."""
    pad = gi < 0
    safe = torch.clamp_min(gi, 0)
    s = torch.where(pad, -torch.inf, score[safe])           # (q, G)
    rel = torch.where(pad, 0.0, y[safe])
    # pad slots contribute zero gain whatever the table's entry for label 0
    gain = torch.where(pad, 0.0, _label_gain(rel, label_gain))

    # rank by current score, descending; stable, so ties keep row order
    # and the -inf pads stay last
    order = torch.argsort(-s, dim=1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(s.shape[1], device=s.device)
                   .expand_as(order).contiguous())
    disc = 1.0 / torch.log2(ranks + 2.0)
    disc = torch.where(ranks < truncation, disc, 0.0)

    ideal = torch.sort(gain, dim=1, descending=True, stable=True).values
    k = torch.arange(gain.shape[1], device=s.device)
    ideal_disc = torch.where(k < truncation, 1.0 / torch.log2(k + 2.0), 0.0)
    idcg = (ideal * ideal_disc[None, :]).sum(dim=1)
    inv_idcg = torch.where(idcg > 0, 1.0 / idcg, 0.0)

    ds = s[:, :, None] - s[:, None, :]                      # (q, G, G)
    rho = torch.sigmoid(-sigmoid * ds)                      # 1/(1+e^{sigma*ds})
    delta = torch.abs((gain[:, :, None] - gain[:, None, :])
                      * (disc[:, :, None] - disc[:, None, :])) \
        * inv_idcg[:, None, None]
    better = rel[:, :, None] > rel[:, None, :]
    valid = better & ~pad[:, :, None] & ~pad[:, None, :]
    lam = torch.where(valid, -sigmoid * rho * delta, 0.0)
    hs = torch.where(valid, sigmoid * sigmoid * rho * (1 - rho) * delta, 0.0)

    g_item = lam.sum(dim=2) - lam.sum(dim=1)   # winners pulled up, losers down
    h_item = hs.sum(dim=2) + hs.sum(dim=1)
    return g_item[~pad], h_item[~pad], gi[~pad]


def lambdarank_objective(group_index, sigmoid: float = 2.0,
                         truncation: int = 30,
                         label_gain: tuple = ()) -> Objective:
    """LambdaRank with NDCG weighting (LightGBM lambdarank). ``group_index``
    is the (Q, Gmax) padded row-index matrix of :func:`make_grouped`. The
    gradients are the JAX package's per-group pair-matrix function, computed
    over the chunks of :func:`query_chunks` (``PAIR_BUDGET`` bounds each)
    and scattered into g and h."""
    chunks = query_chunks(group_index, PAIR_BUDGET)
    on_device: dict = {}

    def gh(score, y, w):
        dev = score.device
        if dev not in on_device:
            on_device[dev] = [torch.as_tensor(c, device=dev) for c in chunks]
        g = torch.zeros_like(score)
        h = torch.zeros_like(score)
        for gi in on_device[dev]:
            g_item, h_item, rows = _lambdarank_chunk(score, y, gi, sigmoid,
                                                     truncation, label_gain)
            g[rows] = g_item
            h[rows] = h_item
        return g * w, torch.clamp_min(h * w, 1e-16)

    return Objective("lambdarank", 1, gh,
                     lambda y, w: torch.zeros((), dtype=torch.float32,
                                              device=y.device),
                     lambda sc: sc)


# ---------------------------------------------------------------------------

_FACTORIES = {
    "binary": lambda p: binary_objective(p.get("sigmoid", 1.0)),
    "multiclass": lambda p: multiclass_objective(p["num_class"]),
    "softmax": lambda p: multiclass_objective(p["num_class"]),
    "multiclassova": lambda p: multiclassova_objective(p["num_class"], p.get("sigmoid", 1.0)),
    "regression": lambda p: regression_objective(),
    "mean_squared_error": lambda p: regression_objective(),
    "l2": lambda p: regression_objective(),
    "regression_l1": lambda p: regression_l1_objective(),
    "l1": lambda p: regression_l1_objective(),
    "mae": lambda p: regression_l1_objective(),
    "huber": lambda p: huber_objective(p.get("alpha", 0.9)),
    "fair": lambda p: fair_objective(p.get("fair_c", 1.0)),
    "poisson": lambda p: poisson_objective(p.get("poisson_max_delta_step", 0.7)),
    "quantile": lambda p: quantile_objective(p.get("alpha", 0.5)),
    "mape": lambda p: mape_objective(),
    "gamma": lambda p: gamma_objective(),
    "cross_entropy": lambda p: cross_entropy_objective(),
    "xentropy": lambda p: cross_entropy_objective(),
    "tweedie": lambda p: tweedie_objective(p.get("tweedie_variance_power", 1.5)),
}


def get_objective(name: str, **params) -> Objective:
    if name not in _FACTORIES:
        raise ValueError(f"unknown objective {name!r}; known: {sorted(_FACTORIES)} + lambdarank")
    return _FACTORIES[name](params)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def auc(y_true, y_score, sample_weight=None) -> torch.Tensor:
    """Weighted ROC AUC with exact tie handling: each positive counts the
    negatives scored strictly below it plus HALF the negatives it ties with
    (the trapezoid rule — what LightGBM/sklearn compute)."""
    y_true = torch.as_tensor(y_true, dtype=torch.float32)
    y_score = torch.as_tensor(y_score, dtype=torch.float32, device=y_true.device)
    w = (torch.ones_like(y_true) if sample_weight is None
         else torch.as_tensor(sample_weight, dtype=torch.float32,
                              device=y_true.device))
    order = torch.argsort(y_score, stable=True)
    ys, ws, ss = y_true[order], w[order], y_score[order]
    wneg = torch.where(ys == 0, ws, 0.0)
    cum = torch.cat([torch.zeros(1, device=ys.device), torch.cumsum(wneg, 0)])
    left = torch.searchsorted(ss, ss, side="left")
    right = torch.searchsorted(ss, ss, side="right")
    neg_below = cum[left]
    tie_neg = cum[right] - cum[left]
    auc_sum = torch.where(ys > 0, ws * (neg_below + 0.5 * tie_neg), 0.0).sum()
    pos = torch.where(ys > 0, ws, 0.0).sum()
    neg = wneg.sum()
    return auc_sum / torch.clamp_min(pos * neg, 1e-12)


def _wmean(v, w=None):
    """Weighted mean — every LightGBM metric weights per-row losses by the
    validation sample weights when provided."""
    if w is None:
        return v.mean()
    w = torch.as_tensor(w, dtype=torch.float32, device=v.device)
    return (v * w).sum() / torch.clamp_min(w.sum(), 1e-12)


def binary_logloss(y_true, p, eps=1e-15, weight=None) -> torch.Tensor:
    p = torch.clamp(p, eps, 1 - eps)
    return _wmean(-(y_true * torch.log(p) + (1 - y_true) * torch.log1p(-p)),
                  weight)


def multi_logloss(y_true, p, eps=1e-15, weight=None) -> torch.Tensor:
    p = torch.clamp(p, eps, 1.0)
    return _wmean(-torch.log(torch.gather(
        p, 1, y_true.to(torch.int64)[:, None])[:, 0]), weight)


def rmse(y_true, pred, weight=None) -> torch.Tensor:
    return torch.sqrt(_wmean((y_true - pred) ** 2, weight))


def mae(y_true, pred, weight=None) -> torch.Tensor:
    return _wmean(torch.abs(y_true - pred), weight)


def _ranked(labels, scores, group_index):
    gi = torch.as_tensor(np.asarray(group_index), device=scores.device)
    pad = gi < 0
    safe = torch.clamp_min(gi, 0)
    s = torch.where(pad, -torch.inf, scores[safe])
    rel = torch.where(pad, 0.0, labels[safe])
    return pad, s, rel


def ndcg_at_k(labels, scores, group_index, k: int = 5,
              label_gain: tuple = ()) -> torch.Tensor:
    """Mean NDCG@k over groups; group_index as in :func:`make_grouped`."""
    pad, s, rel = _ranked(labels, scores, group_index)
    gain = torch.where(pad, 0.0, _label_gain(rel, label_gain))
    order = torch.argsort(-s, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    disc = torch.where(ranks < k, 1.0 / torch.log2(ranks + 2.0), 0.0)
    dcg = (gain * disc).sum(dim=1)
    ideal = torch.sort(gain, dim=1, descending=True, stable=True).values
    j = torch.arange(gain.shape[1], device=s.device)
    idisc = torch.where(j < k, 1.0 / torch.log2(j + 2.0), 0.0)
    idcg = (ideal * idisc[None, :]).sum(dim=1)
    return torch.where(idcg > 0, dcg / torch.clamp_min(idcg, 1e-12),
                       1.0).mean()


def map_at_k(labels, scores, group_index, k: int = 5) -> torch.Tensor:
    """Mean average precision @k over groups (LightGBM map metric: binary
    relevance label > 0, AP normalized by min(#positives, k))."""
    pad, s, rel = _ranked(labels, scores, group_index)
    rel = (rel > 0).to(torch.float32)
    order = torch.argsort(-s, dim=1, stable=True)
    rel_sorted = torch.gather(rel, 1, order)
    pos = torch.arange(rel.shape[1], dtype=torch.float32,
                       device=s.device)[None, :]
    cum_hits = torch.cumsum(rel_sorted, dim=1)
    prec = cum_hits / (pos + 1.0)
    in_k = (pos < k).to(torch.float32)
    ap_sum = (prec * rel_sorted * in_k).sum(dim=1)
    npos = rel.sum(dim=1)
    denom = torch.clamp_max(npos, float(k))
    return torch.where(denom > 0, ap_sum / torch.clamp_min(denom, 1.0),
                       1.0).mean()


def poisson_metric(y, pred, w=None):
    """LightGBM PoissonMetric: pred - y*log(pred) (psi const dropped)."""
    p = torch.clamp_min(pred, 1e-15)
    return _wmean(p - y * torch.log(p), w)


def gamma_metric(y, pred, w=None):
    p = torch.clamp_min(pred, 1e-15)
    return _wmean(y / p + torch.log(p), w)


def gamma_deviance_metric(y, pred, w=None):
    p = torch.clamp_min(pred, 1e-15)
    return 2.0 * _wmean(torch.log(p / torch.clamp_min(y, 1e-15)) + y / p - 1.0,
                        w)


def tweedie_metric(y, pred, rho: float = 1.5, w=None):
    p = torch.clamp_min(pred, 1e-15)
    return _wmean(-y * p ** (1.0 - rho) / (1.0 - rho)
                  + p ** (2.0 - rho) / (2.0 - rho), w)


def quantile_metric(y, pred, alpha: float = 0.9, w=None):
    d = y - pred
    return _wmean(torch.maximum(alpha * d, (alpha - 1.0) * d), w)


def huber_metric(y, pred, alpha: float = 0.9, w=None):
    d = y - pred
    return _wmean(torch.where(torch.abs(d) <= alpha, 0.5 * d * d,
                              alpha * (torch.abs(d) - 0.5 * alpha)), w)


def fair_metric(y, pred, c: float = 1.0, w=None):
    ad = torch.abs(y - pred)
    return _wmean(c * c * (ad / c - torch.log1p(ad / c)), w)


def metric_kwargs(cfg) -> dict:
    """The hyper-parameterized metrics' inputs, from one place."""
    if cfg is None:
        return {}
    return {"alpha": cfg.alpha, "fair_c": cfg.fair_c,
            "tweedie_variance_power": cfg.tweedie_variance_power}


# Every entry honors kw["weight"] (validation sample weights) the way the
# corresponding LightGBM metric does.
METRICS = {
    "auc": lambda y, pred, **kw: auc(y, pred, kw.get("weight")),
    "binary_logloss": lambda y, pred, **kw: binary_logloss(
        y, pred, weight=kw.get("weight")),
    "binary_error": lambda y, pred, **kw: _wmean(
        ((pred > 0.5) != (y > 0.5)).to(torch.float32), kw.get("weight")),
    "multi_logloss": lambda y, pred, **kw: multi_logloss(
        y, pred, weight=kw.get("weight")),
    "multi_error": lambda y, pred, **kw: _wmean(
        (torch.argmax(pred, -1) != y).to(torch.float32), kw.get("weight")),
    "rmse": lambda y, pred, **kw: rmse(y, pred, weight=kw.get("weight")),
    "l2": lambda y, pred, **kw: _wmean((y - pred) ** 2, kw.get("weight")),
    "mse": lambda y, pred, **kw: _wmean((y - pred) ** 2, kw.get("weight")),
    "mae": lambda y, pred, **kw: mae(y, pred, weight=kw.get("weight")),
    "l1": lambda y, pred, **kw: _wmean(torch.abs(y - pred), kw.get("weight")),
    # LightGBM MAPEMetric: |y - pred| / max(1, |y|)
    "mape": lambda y, pred, **kw: _wmean(
        torch.abs(y - pred) / torch.clamp_min(torch.abs(y), 1.0),
        kw.get("weight")),
    # loss-metrics of the exp-family / robust objectives (pred is in the
    # response space: the exp link is already applied)
    "poisson": lambda y, pred, **kw: poisson_metric(y, pred,
                                                    w=kw.get("weight")),
    "gamma": lambda y, pred, **kw: gamma_metric(y, pred,
                                                w=kw.get("weight")),
    "gamma_deviance": lambda y, pred, **kw: gamma_deviance_metric(
        y, pred, w=kw.get("weight")),
    "tweedie": lambda y, pred, **kw: tweedie_metric(
        y, pred, kw.get("tweedie_variance_power", 1.5),
        w=kw.get("weight")),
    "quantile": lambda y, pred, **kw: quantile_metric(
        y, pred, kw.get("alpha", 0.9), w=kw.get("weight")),
    "huber": lambda y, pred, **kw: huber_metric(
        y, pred, kw.get("alpha", 0.9), w=kw.get("weight")),
    # cross_entropy metric: soft-label log loss == binary_logloss
    "cross_entropy": lambda y, pred, **kw: binary_logloss(
        y, pred, weight=kw.get("weight")),
    "xentropy": lambda y, pred, **kw: binary_logloss(
        y, pred, weight=kw.get("weight")),
    "fair": lambda y, pred, **kw: fair_metric(
        y, pred, kw.get("fair_c", 1.0), w=kw.get("weight")),
}

HIGHER_IS_BETTER = {"auc", "ndcg", "map"}
