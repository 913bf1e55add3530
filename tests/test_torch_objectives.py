"""The port's boosting objectives and eval metrics against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages as
arrays. Tolerances, each with its reason:

* gradients and hessians: 1e-6 relative to the vector's largest magnitude
  (float32 softmax, exp, log, log2 and pow of two libraries differ in the
  last bits; where a gradient is a difference of nearly equal terms, such
  as exp(score) - y, one ulp of a term is a large part of the difference);
* init scores: 1e-6 relative with an absolute floor of 2e-6 (float32 sums
  and prefix sums of 2000 weighted labels taken in another order, then a
  log-odds or an interpolation between two labels: the bound of the binary
  init score in tests/test_torch_gbdt.py);
* metrics: 1e-6 relative (float32 reductions taken in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.gbdt import objectives as jobj
from synapseml_tpu_torch.gbdt import objectives as tobj
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

RTOL, ATOL = 1e-6, 1e-7
INIT_ATOL = 2e-6
N = 2000


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _close_normwise(got, want):
    want = np.asarray(want, np.float64)
    _close(got, want, atol=RTOL * float(np.abs(want).max()))


def _label(name, rng, n=N):
    """A label in the objective's own domain."""
    z = rng.normal(size=n).astype(np.float32)
    if name in ("poisson", "tweedie"):
        return np.floor(np.exp(z)).astype(np.float32)         # >= 0
    if name == "gamma":
        return np.exp(z).astype(np.float32)                   # > 0
    if name in ("cross_entropy", "xentropy"):
        return (1 / (1 + np.exp(-2 * z))).astype(np.float32)  # in [0, 1]
    return (3 * z).astype(np.float32)


def _both(name, **params):
    return (tobj.get_objective(name, **params),
            jobj.get_objective(name, **params))


def _grad_hess_case(tob, job, score, y, w):
    tg, th = tob.grad_hess(torch.from_numpy(score), torch.from_numpy(y),
                           torch.from_numpy(w))
    jg, jh = job.grad_hess(jnp.asarray(score), jnp.asarray(y),
                           jnp.asarray(w))
    _close_normwise(tg.numpy(), jg)
    _close_normwise(th.numpy(), jh)
    _close(tob.init_score(torch.from_numpy(y), torch.from_numpy(w)).numpy(),
           job.init_score(jnp.asarray(y), jnp.asarray(w)), atol=INIT_ATOL)


REGRESSION = [
    ("regression", {}), ("l2", {}), ("regression_l1", {}), ("mae", {}),
    ("huber", {"alpha": 0.9}), ("huber", {"alpha": 2.5}),
    ("fair", {"fair_c": 1.0}), ("fair", {"fair_c": 0.3}),
    ("poisson", {"poisson_max_delta_step": 0.7}),
    ("quantile", {"alpha": 0.2}), ("quantile", {"alpha": 0.9}),
    ("mape", {}), ("gamma", {}),
    ("tweedie", {"tweedie_variance_power": 1.5}),
    ("tweedie", {"tweedie_variance_power": 1.2}),
    ("cross_entropy", {}), ("xentropy", {}), ("binary", {"sigmoid": 1.7}),
]


@pytest.mark.parametrize("name,params", REGRESSION,
                         ids=[f"{n}-{'-'.join(map(str, p.values()))}"
                              for n, p in REGRESSION])
def test_single_output_objectives_match_reference(name, params):
    rng = np.random.default_rng(len(name))
    y = _label(name, rng)
    score = rng.normal(size=N).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    w[::17] = 0.0                                   # zero-weight rows
    tob, job = _both(name, **params)
    assert tob.name == job.name and tob.num_model_per_iteration == 1
    _grad_hess_case(tob, job, score, y, w)
    sc = torch.from_numpy(score)
    _close(tob.transform(sc).numpy(), job.transform(jnp.asarray(score)))


@pytest.mark.parametrize("name", ["multiclass", "softmax", "multiclassova"])
def test_multiclass_objectives_match_reference(name):
    """K = 4 with class 2 carrying zero weight everywhere."""
    K = 4
    rng = np.random.default_rng(7)
    y = rng.integers(0, K, size=N).astype(np.float32)
    score = rng.normal(size=(N, K)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    w[y == 2] = 0.0
    tob, job = _both(name, num_class=K, sigmoid=1.3)
    assert tob.num_model_per_iteration == K
    _grad_hess_case(tob, job, score, y, w)
    _close(tob.transform(torch.from_numpy(score)).numpy(),
           job.transform(jnp.asarray(score)))


@pytest.mark.parametrize("case", ["uniform", "weighted", "zero_weights",
                                  "last_row", "all_zero_but_one", "ties"])
@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 0.9, 1.0])
def test_weighted_quantile_edge_cases(case, alpha):
    rng = np.random.default_rng(11)
    n = 41
    y = rng.normal(size=n).astype(np.float32)
    w = np.ones(n, np.float32)
    if case == "weighted":
        w = rng.uniform(0.1, 3.0, size=n).astype(np.float32)
    elif case == "zero_weights":
        w[rng.random(n) < 0.4] = 0.0
    elif case == "last_row":
        # the quantile lands in the last positive-weight row's span, with
        # zero-weight rows after it in sorted order
        w[:] = 0.0
        w[:3] = [1.0, 1.0, 5.0]
        y[2] = y.max() + 1
    elif case == "all_zero_but_one":
        w[:] = 0.0
        w[5] = 2.0
    elif case == "ties":
        y = np.round(y).astype(np.float32)
    got = tobj._weighted_quantile(torch.from_numpy(y), torch.from_numpy(w),
                                  alpha)
    want = jobj._weighted_quantile(jnp.asarray(y), jnp.asarray(w), alpha)
    assert np.isfinite(float(got))
    _close(got.numpy(), want, atol=INIT_ATOL)


def _groups(rng, q, gmax):
    sizes = rng.integers(1, gmax + 1, size=q)
    sizes[0] = gmax                                 # the widest group
    sizes[1] = 1                                    # a group of one
    return sizes


LAMBDARANK = [
    # name, label_gain, truncation, pair_budget, equal scores
    ("ragged", (), 30, tobj.PAIR_BUDGET, False),
    ("ties", (), 30, tobj.PAIR_BUDGET, True),
    ("label_gain", (0.0, 1.0, 3.0, 7.5, 20.0), 30, tobj.PAIR_BUDGET, False),
    ("truncated", (), 3, tobj.PAIR_BUDGET, False),
    ("chunked", (), 30, 600, False),
    ("chunked_ties", (0.0, 1.0, 3.0, 7.5, 20.0), 5, 300, True),
]


@pytest.mark.parametrize("name,label_gain,trunc,budget,tied", LAMBDARANK,
                         ids=[c[0] for c in LAMBDARANK])
def test_lambdarank_matches_reference(monkeypatch, name, label_gain, trunc,
                                      budget, tied):
    """Ragged groups (one of one row), all-equal scores (iteration 0: ranks
    from the stable sort order alone), a label_gain table, a truncation,
    and the chunked layout forced to several chunks."""
    rng = np.random.default_rng(len(name))
    sizes = _groups(rng, 40, 17)
    n = int(sizes.sum())
    y = rng.integers(0, 5, size=n).astype(np.float32)
    score = (np.zeros(n, np.float32) if tied
             else rng.normal(size=n).astype(np.float32))
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    gi_t = tobj.make_grouped(y, sizes)
    gi_j = jobj.make_grouped(y, sizes)
    np.testing.assert_array_equal(gi_t, gi_j)
    chunks = tobj.query_chunks(gi_t, budget)
    if budget < tobj.PAIR_BUDGET:
        assert len(chunks) > 2
    for c in chunks:                                # the budget bounds each
        assert len(c) == 1 or c.size * c.shape[1] <= budget
    assert sorted(np.concatenate([c[c >= 0] for c in chunks]).tolist()) \
        == list(range(n))
    monkeypatch.setattr(tobj, "PAIR_BUDGET", budget)
    tob = tobj.lambdarank_objective(gi_t, 2.0, trunc, label_gain)
    job = jobj.lambdarank_objective(jnp.asarray(gi_j), 2.0, trunc,
                                    label_gain)
    _grad_hess_case(tob, job, score, y, w)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

METRIC_NAMES = sorted(set(jobj.METRICS) - {"multi_logloss", "multi_error"})


@pytest.mark.parametrize("name", METRIC_NAMES)
@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_match_reference(name, weighted):
    rng = np.random.default_rng(3)
    if name in ("auc", "binary_logloss", "binary_error", "cross_entropy",
                "xentropy"):
        y = (rng.random(N) < 0.4).astype(np.float32)
        pred = rng.uniform(0.01, 0.99, size=N).astype(np.float32)
    else:
        y = np.abs(rng.normal(size=N)).astype(np.float32) + 0.1
        pred = np.abs(rng.normal(size=N)).astype(np.float32) + 0.1
    kw = {"alpha": 0.7, "fair_c": 0.5, "tweedie_variance_power": 1.3}
    if weighted:
        kw["weight"] = rng.uniform(0.2, 2.0, size=N).astype(np.float32)
    got = tobj.METRICS[name](torch.from_numpy(y), torch.from_numpy(pred),
                             **{k: (torch.from_numpy(v)
                                    if isinstance(v, np.ndarray) else v)
                                for k, v in kw.items()})
    want = jobj.METRICS[name](jnp.asarray(y), jnp.asarray(pred), **kw)
    _close(got.numpy(), want, atol=0)


@pytest.mark.parametrize("name", ["multi_logloss", "multi_error"])
def test_multiclass_metrics_match_reference(name):
    rng = np.random.default_rng(4)
    y = rng.integers(0, 5, size=N).astype(np.float32)
    p = rng.uniform(size=(N, 5)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    got = tobj.METRICS[name](torch.from_numpy(y), torch.from_numpy(p))
    want = jobj.METRICS[name](jnp.asarray(y), jnp.asarray(p))
    _close(got.numpy(), want, atol=0)


@pytest.mark.parametrize("metric", ["ndcg", "map"])
@pytest.mark.parametrize("k", [1, 3, 10])
def test_ranking_metrics_match_reference(metric, k):
    rng = np.random.default_rng(k)
    sizes = _groups(rng, 30, 12)
    n = int(sizes.sum())
    y = rng.integers(0, 4, size=n).astype(np.float32)
    y[:sizes[0]] = 0                                # a group without hits
    s = np.round(rng.normal(size=n), 1).astype(np.float32)   # with ties
    gi = tobj.make_grouped(y, sizes)
    if metric == "ndcg":
        got = tobj.ndcg_at_k(torch.from_numpy(y), torch.from_numpy(s), gi, k,
                             label_gain=(0.0, 1.0, 2.5, 9.0))
        want = jobj.ndcg_at_k(jnp.asarray(y), jnp.asarray(s), gi, k,
                              label_gain=(0.0, 1.0, 2.5, 9.0))
    else:
        got = tobj.map_at_k(torch.from_numpy(y), torch.from_numpy(s), gi, k)
        want = jobj.map_at_k(jnp.asarray(y), jnp.asarray(s), gi, k)
    _close(got.numpy(), want, atol=0)


def test_metric_kwargs_and_factories_match_reference():
    from synapseml_tpu.gbdt.boosting import BoosterConfig as JConfig
    from synapseml_tpu_torch.gbdt.boosting import BoosterConfig as TConfig

    kw = dict(alpha=0.3, fair_c=2.0, tweedie_variance_power=1.1)
    assert tobj.metric_kwargs(TConfig(**kw)) == jobj.metric_kwargs(
        JConfig(**kw))
    assert tobj.metric_kwargs(None) == {}
    assert set(tobj._FACTORIES) == set(jobj._FACTORIES)
    assert set(tobj.METRICS) == set(jobj.METRICS)
    assert tobj.HIGHER_IS_BETTER == jobj.HIGHER_IS_BETTER
    with pytest.raises(ValueError, match="unknown objective"):
        tobj.get_objective("no_such_objective")
