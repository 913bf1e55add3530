"""The port's sampling and monotone constraints against the JAX package's:
the threefry stream of ``core/prng.py`` against ``jax.random``, then
``train_booster`` under GOSS, bagging (plain, every third iteration,
stratified), feature fractions per tree and per node, RF, DART (weighted,
uniform, xgboost mode, its own seed) and monotone constraints, under both
growth policies; DART and RF validation with early stopping, a DART warm
start, resume, the config checks and the estimators' sampling params.

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``device="cpu"``, where every histogram goes through the
plain PyTorch version of its CUDA kernel. The JAX fits get a callback
that does nothing: that keeps them on the JAX package's host loop, which
compiles the grower once for every sampling mode of one grower config (its
fused scan gives the same trees and compiles once per config). Tolerances,
each with its reason:

* the random stream (keys, uniforms, permutations, node masks), bags and
  tree structure: exact (the same integer hash; split decisions from
  histograms that agree to the last bits);
* leaf values and raw scores: 1e-5 relative (float32 sums in another
  order; DART rebuilds its score as a weighted sum of per-tree
  contributions, in another order than XLA's ``einsum``); DART's tree
  weights exact (the same host draws and float64 arithmetic);
* the validation metric series: 1e-6 (float32 metrics of scores that
  differ in their last bits), the best iteration exact. The metric is the
  binary log loss, continuous in the scores: AUC jumps by 1 / (P N) where
  scores summed in another order split or join a tie;
* resume: bitwise equal to an uninterrupted port fit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synapseml_tpu.core import Table as JTable
from synapseml_tpu.core import assemble_features as j_assemble
from synapseml_tpu.gbdt import boosting as jboost
from synapseml_tpu.gbdt import grower as jgrower
from synapseml_tpu.models import LightGBMClassifier as JClassifier
from synapseml_tpu.models import LightGBMRanker as JRanker
from synapseml_tpu.models import LightGBMRegressor as JRegressor
from synapseml_tpu.ops.hist_kernel import features_padded

from synapseml_tpu_torch.convert import booster_arrays, booster_from_reference
from synapseml_tpu_torch.core import Table, assemble_features
from synapseml_tpu_torch.core import checkpoint as tckpt
from synapseml_tpu_torch.core import prng
from synapseml_tpu_torch.gbdt import boosting as tboost
from synapseml_tpu_torch.gbdt import grower as tgrower
from synapseml_tpu_torch.models import (LightGBMClassifier, LightGBMRanker,
                                        LightGBMRegressor)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
N, F = 1000, 8
TOL = 1e-5
METRIC_TOL = 1e-6
POLICIES = ("leafwise", "depthwise")
BASE = dict(num_iterations=8, num_leaves=15, min_data_in_leaf=5)


def _host_loop(it, trees):
    """Does nothing: keeps a JAX fit on its host loop."""


def _data(kind="binary", n=N, seed=0):
    """(X, y, train_booster kwargs): feature 3 has missing values; labels
    from X0*X1 + 0.5*X2 + noise (binary, 3 classes, 0-4 relevance in
    queries of 10, or the margin itself)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random(n) < 0.08, 3] = np.nan
    z = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2]
         + 0.5 * rng.normal(size=n)).astype(np.float32)
    kw = {}
    if kind == "binary":
        y = (z > 0).astype(np.float32)
    elif kind == "multiclass":
        y = np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    elif kind == "rank":
        y = np.clip(np.digitize(z, [-1, 0, 0.5, 1]), 0, 4).astype(np.float32)
        kw["group_sizes"] = np.full(n // 10, 10)
    else:
        y = z
    return X, y, kw


# ---------------------------------------------------------------------------
# the threefry stream
# ---------------------------------------------------------------------------

def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_jax_threefry_is_partitionable():
    # core/prng.py copies the partitionable stream (JAX's default since
    # 0.5); a change of that default changes every draw of the JAX package
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 3, 7, 2**31 - 1])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(np.asarray(prng.prng_key(seed)),
                                  _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [0, 7, 10_000_003, 20_000_005, 30_000_002])
def test_fold_in_matches_jax(data):
    for seed in (0, 3):
        want = _words(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        np.testing.assert_array_equal(
            np.asarray(prng.fold_in(prng.prng_key(seed), data)), want)


def test_fold_in_batches_over_data():
    nids = np.arange(29)
    key = prng.fold_in(prng.prng_key(5), 30_000_001)
    got = prng.fold_in(key, torch.as_tensor(nids)).numpy()
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 30_000_001)
    want = np.stack([_words(jax.random.fold_in(jkey, int(i))) for i in nids])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 1000, 4097])
def test_uniform_matches_jax_bitwise(n):
    key = jax.random.fold_in(jax.random.PRNGKey(0), 20_000_000 + n)
    want = np.asarray(jax.random.uniform(key, (n,)))
    got = prng.uniform(prng.fold_in(prng.prng_key(0), 20_000_000 + n),
                       n).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_split_matches_jax():
    jkey = jax.random.fold_in(jax.random.PRNGKey(7), 11)
    key = prng.fold_in(prng.prng_key(7), 11)
    for num in (2, 3):
        np.testing.assert_array_equal(np.asarray(prng.split(key, num)),
                                      _words(jax.random.split(jkey, num)))


@pytest.mark.parametrize("n", [1, 2, 28, 1000])
def test_permutation_matches_jax(n):
    for seed in (0, 3):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 10_000_000 + n)
        key = prng.fold_in(prng.prng_key(seed), 10_000_000 + n)
        np.testing.assert_array_equal(
            prng.permutation(key, n).numpy(),
            np.asarray(jax.random.permutation(jkey, n)))


@pytest.mark.parametrize("frac,active", [(0.5, 8), (0.3, 5), (0.9, 28)])
def test_node_masks_match_node_mask_fn(frac, active):
    """Every node id's mask of one tree, drawn in one batch, against the
    JAX grower's per-node sampler."""
    L, f = 15, 28
    FP = features_padded(f)
    featp = np.zeros(FP, bool)
    featp[np.random.default_rng(active).permutation(f)[:active]] = True
    jkey = jboost._node_key_data(jax.random.PRNGKey(0), 4, 1)
    fn = jgrower._node_mask_fn(jgrower.GrowerConfig(
        feature_fraction_bynode=frac), jnp.asarray(featp), f, jkey)
    want = np.stack([np.asarray(fn(jnp.int32(i))) for i in range(2 * L - 1)])
    got = tgrower.node_masks(
        tgrower.GrowerConfig(feature_fraction_bynode=frac),
        torch.as_tensor(featp), tboost._node_key_data(prng.prng_key(0), 4, 1),
        L)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(1) == max(1, int(np.ceil(frac * active)))).all()


@pytest.mark.parametrize("it", [0, 3, 5])
def test_bags_and_feature_masks_match_the_jax_draws(it):
    """``_sample_rows_impl`` (bagging every 5 iterations, carried between)
    and ``_sample_features_impl`` against the JAX package's."""
    n = 3001
    cfg = dict(objective="binary", bagging_fraction=0.8, bagging_freq=5,
               feature_fraction=0.9, feature_fraction_seed=2)
    g = np.random.default_rng(it).normal(size=(n, 1)).astype(np.float32)
    carried = (np.random.default_rng(9).random(n) < 0.5).astype(np.float32)
    jbag, _, _, jcur = jboost._sample_rows_impl(
        jboost.BoosterConfig(**cfg), n, jax.random.PRNGKey(0),
        jnp.ones(n), it, jnp.asarray(g), jnp.asarray(g), jnp.asarray(carried))
    tbag, _, _, tcur = tboost._sample_rows_impl(
        tboost.BoosterConfig(**cfg), n, prng.prng_key(0), it,
        torch.as_tensor(g.T), torch.as_tensor(g.T), torch.as_tensor(carried))
    np.testing.assert_array_equal(tbag.numpy(), np.asarray(jbag))
    np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
    assert (it % 5 == 0) != np.array_equal(tbag.numpy(), carried)
    jmask = jboost._sample_features_impl(jboost.BoosterConfig(**cfg), 28,
                                         jax.random.PRNGKey(0), it)
    tmask = tboost._sample_features_impl(tboost.BoosterConfig(**cfg), 28,
                                         prng.prng_key(0), it, "cpu")
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert int(tmask.sum()) == 26


def test_goss_amplifies_the_jax_rows():
    """One GOSS draw on 3 classes: the kept rows, their weights and the
    amplified gradients are the JAX package's."""
    n, k = 2000, 3
    rng = np.random.default_rng(1)
    g = rng.normal(size=(n, k)).astype(np.float32)
    h = rng.random(size=(n, k)).astype(np.float32)
    cfg = dict(objective="multiclass", num_class=k, boosting_type="goss")
    jin, jg, jh, _ = jboost._sample_rows_impl(
        jboost.BoosterConfig(**cfg), n, jax.random.PRNGKey(0), jnp.ones(n),
        2, jnp.asarray(g), jnp.asarray(h), jnp.ones(n))
    tin, tg, th, _ = tboost._sample_rows_impl(
        tboost.BoosterConfig(**cfg), n, prng.prng_key(0), 2,
        torch.as_tensor(g.T.copy()), torch.as_tensor(h.T.copy()),
        torch.ones(n))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(tg.numpy().T, np.asarray(jg))
    np.testing.assert_array_equal(th.numpy().T, np.asarray(jh))
    kept = int(tin.sum())
    assert int(0.2 * n) < kept < int(0.2 * n) + int(0.2 * n)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

# (data kind, config): every sampling mode and constraint
MODES = {
    "goss": ("binary", dict(boosting_type="goss")),
    "bagging-freq1": ("binary", dict(bagging_fraction=0.7, bagging_freq=1)),
    "bagging-freq3": ("binary", dict(bagging_fraction=0.7, bagging_freq=3,
                                     bagging_seed=11)),
    "bagging-stratified": ("binary", dict(pos_bagging_fraction=0.6,
                                          neg_bagging_fraction=0.8,
                                          bagging_freq=2)),
    "feature-fraction": ("binary", dict(feature_fraction=0.6)),
    "feature-fraction-seed": ("binary", dict(feature_fraction=0.6,
                                             feature_fraction_seed=5)),
    "bynode": ("binary", dict(feature_fraction_bynode=0.5)),
    "bynode-and-tree": ("binary", dict(feature_fraction_bynode=0.5,
                                       feature_fraction=0.7)),
    "rf": ("binary", dict(boosting_type="rf", bagging_fraction=0.7,
                          bagging_freq=1, feature_fraction=0.8)),
    "dart": ("binary", dict(boosting_type="dart")),
    "dart-uniform": ("binary", dict(boosting_type="dart", uniform_drop=True,
                                    skip_drop=0.2, drop_rate=0.3)),
    "dart-xgboost": ("binary", dict(boosting_type="dart",
                                    xgboost_dart_mode=True, skip_drop=0.2)),
    "dart-drop-seed": ("binary", dict(boosting_type="dart", drop_seed=4,
                                      skip_drop=0.2, max_drop=2)),
    "monotone-up": ("regression", dict(monotone_constraints=[0, 0, 1])),
    "monotone-down": ("regression", dict(monotone_constraints=[0, -1, -1])),
    "multiclass-goss": ("multiclass", dict(boosting_type="goss",
                                           top_rate=0.3, other_rate=0.2,
                                           extra_seed=2, num_iterations=5)),
    "multiclass-dart": ("multiclass", dict(boosting_type="dart",
                                           skip_drop=0.3, num_iterations=5)),
    "lambdarank-bagging": ("rank", dict(bagging_fraction=0.7,
                                        bagging_freq=1, num_iterations=5)),
}
OBJECTIVES = {"binary": dict(objective="binary"),
              "multiclass": dict(objective="multiclass", num_class=3),
              "rank": dict(objective="lambdarank"),
              "regression": dict(objective="regression")}


def _same_trees(tb, jb, start=0):
    assert tb.num_trees == jb.num_trees
    for tt, jt in zip(tb.trees[start:], jb.trees[start:]):
        ns = int(tt.num_splits)
        assert ns == int(jt.num_splits)
        for f in ("split_feature", "split_bin", "default_left", "left_child",
                  "right_child"):
            np.testing.assert_array_equal(np.asarray(getattr(tt, f))[:ns],
                                          np.asarray(getattr(jt, f))[:ns])
        np.testing.assert_allclose(np.asarray(tt.leaf_value)[:ns + 1],
                                   np.asarray(jt.leaf_value)[:ns + 1],
                                   rtol=TOL, atol=TOL)


def _fit_pair(mode, policy, **extra):
    kind, kw = MODES[mode]
    X, y, fkw = _data(kind)
    cfg = {**BASE, "growth_policy": policy, **OBJECTIVES[kind], **kw,
           **extra}
    jb = jboost.train_booster(X, y, jboost.BoosterConfig(**cfg),
                              callbacks=[_host_loop], **fkw)
    tb = tboost.train_booster(X, y, tboost.BoosterConfig(**cfg), device=CPU,
                              **fkw)
    return X, y, cfg, jb, tb


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", list(MODES))
def test_sampled_fit_grows_the_reference_trees(mode, policy):
    X, y, cfg, jb, tb = _fit_pair(mode, policy)
    _same_trees(tb, jb)
    assert tb.tree_weights == jb.tree_weights
    raw_t, raw_j = tb.raw_score(X), np.asarray(jb.raw_score(X))
    np.testing.assert_allclose(raw_t, raw_j, rtol=TOL,
                               atol=TOL * np.abs(raw_j).max())
    if mode.startswith("dart") or mode == "multiclass-dart":
        # some iteration dropped trees: their weights left 1
        assert min(tb.tree_weights) < 1.0
    if mode == "rf":
        assert tb.average_output and "average_output" in tb.model_string()
    if mode.startswith("monotone"):
        _check_monotone(tb, X, cfg["monotone_constraints"])
    # the fit sampled: its trees are not the plain fit's
    if not mode.startswith("monotone"):
        assert not np.array_equal(
            _plain_raw(MODES[mode][0], policy, cfg["num_iterations"]), raw_t)


@functools.lru_cache(maxsize=None)
def _plain_raw(kind, policy, iterations):
    """The raw score of the plain (unsampled) port fit of ``kind``."""
    X, y, fkw = _data(kind)
    cfg = {**BASE, "growth_policy": policy, **OBJECTIVES[kind],
           "num_iterations": iterations}
    return tboost.train_booster(X, y, tboost.BoosterConfig(**cfg),
                                device=CPU, **fkw).raw_score(X)


def _node_value(tree, child) -> float:
    return float(np.asarray(tree.internal_value)[child] if child >= 0
                 else np.asarray(tree.leaf_value)[~child])


def _check_monotone(booster, X, constraints):
    """The constraint as both packages enforce it: at every split on a
    constrained feature the right child's output is on the constraint's
    side of the left child's. (Neither bounds the children's descendants,
    as LightGBM's basic method does, so the raw score itself need not be
    monotone in the feature.)"""
    checked = 0
    for tree in booster.trees:
        for i in range(int(tree.num_splits)):
            sign = constraints[int(tree.split_feature[i])] \
                if tree.split_feature[i] < len(constraints) else 0
            if sign:
                gap = (_node_value(tree, tree.right_child[i])
                       - _node_value(tree, tree.left_child[i]))
                assert sign * gap >= 0
                checked += 1
    assert checked > 0


# ---------------------------------------------------------------------------
# validation and early stopping under DART and RF
# ---------------------------------------------------------------------------

VALID_MODES = {
    "dart": dict(boosting_type="dart", skip_drop=0.2),
    "rf": dict(boosting_type="rf", bagging_fraction=0.6, bagging_freq=1,
               feature_fraction=0.7),
}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", list(VALID_MODES))
def test_dart_and_rf_validation_match_the_reference(mode, policy,
                                                    monkeypatch):
    """The metric series of the stacked, reweighted validation
    contributions and the early-stopping point, against the JAX host loop's
    (its metric values recorded as it computes them)."""
    X, y, _ = _data("binary", n=900, seed=4)
    Xt, yt, valid = X[:600], y[:600], (X[600:], y[600:])
    cfg = dict(BASE, objective="binary", metric="binary_logloss",
               num_iterations=30,
               learning_rate=0.5, early_stopping_round=3,
               growth_policy=policy, **VALID_MODES[mode])
    series = []
    real = jboost._eval_metric

    def recording(*a, **k):
        out = real(*a, **k)
        series.append(float(out))
        return out

    monkeypatch.setattr(jboost, "_eval_metric", recording)
    jb = jboost.train_booster(Xt, yt, jboost.BoosterConfig(**cfg),
                              valid=valid, callbacks=[_host_loop])
    tb = tboost.train_booster(Xt, yt, tboost.BoosterConfig(**cfg),
                              valid=valid, device=CPU)
    _same_trees(tb, jb)
    assert tb.best_iteration == jb.best_iteration
    values = np.asarray(tb.metadata["valid_metric"]["values"])
    np.testing.assert_allclose(values, series, rtol=0, atol=METRIC_TOL)
    assert abs(tb.best_score - jb.best_score) <= METRIC_TOL
    assert len(values) < cfg["num_iterations"]
    assert tb.best_score == values[tb.best_iteration] == values.min()


@pytest.mark.parametrize("init", ["gbdt", "dart"])
def test_dart_warm_start_matches_the_reference(init):
    """DART continued from a booster (carried across by ``convert``): the
    prior trees are drop candidates, their contributions recovered from
    their leaves."""
    X, y, _ = _data("binary", seed=6)
    icfg = dict(BASE, objective="binary", num_iterations=4,
                boosting_type=init, skip_drop=0.0)
    jinit = jboost.train_booster(X, y, jboost.BoosterConfig(**icfg),
                                 callbacks=[_host_loop])
    arrays, config = booster_arrays(jinit)
    tinit = booster_from_reference(arrays, config, device=CPU)
    cfg = dict(BASE, objective="binary", num_iterations=6,
               boosting_type="dart", skip_drop=0.0, drop_rate=0.3)
    jb = jboost.train_booster(X, y, jboost.BoosterConfig(**cfg),
                              init_model=jinit, callbacks=[_host_loop])
    tb = tboost.train_booster(X, y, tboost.BoosterConfig(**cfg),
                              init_model=tinit, device=CPU)
    _same_trees(tb, jb)
    assert tb.tree_weights == jb.tree_weights
    # prior trees were dropped and rescaled
    assert min(tb.tree_weights[:4]) < 1.0
    raw_j = np.asarray(jb.raw_score(X))
    np.testing.assert_allclose(tb.raw_score(X), raw_j, rtol=TOL,
                               atol=TOL * np.abs(raw_j).max())


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

def _stop_after(iteration):
    def cb(it, trees):
        if it == iteration:
            raise tckpt.PreemptionError(f"stopped after {it}")
    return cb


@pytest.mark.parametrize("mode", ["bagging-freq3", "dart", "goss-bynode"])
def test_resume_is_bitwise_the_uninterrupted_fit(tmp_path, mode):
    """The bag carried between bagging rounds, DART's per-tree
    contributions, validation contributions and host generator come back
    from the snapshot: the resumed fit is the uninterrupted one."""
    X, y, _ = _data("binary", n=900, seed=8)
    Xt, yt, valid = X[:600], y[:600], (X[600:], y[600:])
    sampling = {"bagging-freq3": dict(bagging_fraction=0.6, bagging_freq=3),
                "dart": dict(boosting_type="dart", skip_drop=0.1),
                "goss-bynode": dict(boosting_type="goss",
                                    feature_fraction_bynode=0.5)}[mode]
    cfg = tboost.BoosterConfig(**dict(BASE, objective="binary",
                                      num_iterations=9, **sampling))
    full = tboost.train_booster(Xt, yt, cfg, valid=valid, device=CPU)
    store = str(tmp_path / "ckpt")
    with pytest.raises(tckpt.PreemptionError):
        tboost.train_booster(Xt, yt, cfg, valid=valid, device=CPU,
                             checkpoint_store=store, checkpoint_every=2,
                             callbacks=[_stop_after(4)])
    assert tckpt.CheckpointStore(store).latest_step() == 4
    resumed = tboost.train_booster(Xt, yt, cfg, valid=valid, device=CPU,
                                   checkpoint_store=store, checkpoint_every=2)
    assert resumed.num_trees == full.num_trees
    for a, b in zip(resumed.trees, full.trees):
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))
    assert resumed.tree_weights == full.tree_weights
    np.testing.assert_array_equal(resumed.raw_score(X), full.raw_score(X))
    assert (resumed.metadata["valid_metric"]["values"]
            == full.metadata["valid_metric"]["values"])


# ---------------------------------------------------------------------------
# config checks, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(objective="regression", pos_bagging_fraction=0.5, bagging_freq=1),
    dict(objective="binary", boosting_type="rf"),
    dict(objective="binary", boosting_type="rf", bagging_fraction=0.5),
])
def test_degenerate_sampling_configs_raise_the_reference_errors(kw):
    X, y, _ = _data("binary", n=200)
    with pytest.raises(ValueError) as jerr:
        jboost.train_booster(X, y, jboost.BoosterConfig(**kw))
    with pytest.raises(ValueError) as terr:
        tboost.train_booster(X, y, tboost.BoosterConfig(**kw), device=CPU)
    assert str(terr.value) == str(jerr.value)


# every sampling param, set away from its default
SAMPLING_PARAMS = {
    "baggingFraction": 0.7, "baggingFreq": 2, "baggingSeed": 9,
    "posBaggingFraction": 0.9, "negBaggingFraction": 0.8,
    "featureFraction": 0.75, "featureFractionByNode": 0.6,
    "featureFractionSeed": 4, "dropRate": 0.2, "maxDrop": 7,
    "skipDrop": 0.3, "uniformDrop": True, "dropSeed": 5,
    "xGBoostDartMode": True, "topRate": 0.3, "otherRate": 0.15,
    "extraSeed": 6, "monotoneConstraints": [1, 0, -1],
    "monotoneConstraintsMethod": "intermediate", "monotonePenalty": 0.5,
}


@pytest.mark.parametrize("name", list(SAMPLING_PARAMS))
def test_sampling_param_reaches_the_config_as_in_the_reference(name):
    value = SAMPLING_PARAMS[name]
    for cls, jcls in ((LightGBMClassifier, JClassifier),
                      (LightGBMRegressor, JRegressor),
                      (LightGBMRanker, JRanker)):
        tcfg = cls(device=CPU, **{name: value})._base_config()
        jcfg = jcls(**{name: value})._base_config()
        for field in ("bagging_fraction", "bagging_freq", "bagging_seed",
                      "pos_bagging_fraction", "neg_bagging_fraction",
                      "feature_fraction", "feature_fraction_bynode",
                      "feature_fraction_seed", "drop_rate", "max_drop",
                      "skip_drop", "uniform_drop", "drop_seed",
                      "xgboost_dart_mode", "top_rate", "other_rate",
                      "extra_seed", "monotone_constraints"):
            assert getattr(tcfg, field) == getattr(jcfg, field), field
        assert cls(device=CPU, **{name: value}).get(name) == value


ESTIMATOR_CASES = {
    "classifier-bagging": (LightGBMClassifier, JClassifier, "binary", dict(
        baggingFraction=0.8, baggingFreq=5, featureFraction=0.9)),
    "classifier-dart": (LightGBMClassifier, JClassifier, "binary", dict(
        boostingType="dart", dropRate=0.3, skipDrop=0.2, dropSeed=3)),
    "regressor-monotone": (LightGBMRegressor, JRegressor, "regression", dict(
        monotoneConstraints=[0, 0, 1], monotonePenalty=0.2,
        baggingFraction=0.7, baggingFreq=1, baggingSeed=5)),
    "ranker-bagging": (LightGBMRanker, JRanker, "rank", dict(
        baggingFraction=0.7, baggingFreq=2, featureFraction=0.8,
        featureFractionSeed=2)),
}


@pytest.mark.parametrize("case", list(ESTIMATOR_CASES))
def test_estimator_sampling_params_give_the_reference_model_string(case):
    cls, jcls, kind, params = ESTIMATOR_CASES[case]
    X, y, kw = _data(kind, n=1000, seed=2)
    cols = {f"f{i}": X[:, i] for i in range(F)}
    extra = {}
    if "group_sizes" in kw:
        extra["group"] = np.repeat(np.arange(len(kw["group_sizes"])),
                                   10).astype(np.int64)
    jt = j_assemble(JTable({**cols, "label": y, **extra}), list(cols))
    tt = assemble_features(Table({**cols, "label": y, **extra}), list(cols))
    common = dict(numIterations=6, numLeaves=15, minDataInLeaf=5, **params)
    if kind == "rank":
        common["groupCol"] = "group"
    jmodel = jcls(**common).fit(jt)
    tmodel = cls(device=CPU, **common).fit(tt)
    _same_trees(tmodel.booster, jmodel.booster)
    assert tmodel.booster.tree_weights == jmodel.booster.tree_weights
    # the same trees carried across print the reference's string byte for
    # byte; the port's own string differs at most in the last digits of its
    # float32 sums (and so in the trees' byte sizes)
    arrays, config = booster_arrays(jmodel.booster)
    carried = booster_from_reference(arrays, config, device=CPU)
    assert carried.model_string() == jmodel.booster.model_string()
    tlines = tmodel.booster.model_string().splitlines()
    jlines = jmodel.booster.model_string().splitlines()
    assert len(tlines) == len(jlines)
    assert all(a == b for a, b in zip(tlines, jlines)
               if not a.startswith(SUMMED_FIELDS))


# model-string lines printing float32 sums (or the trees' sizes in bytes)
SUMMED_FIELDS = ("tree_sizes=", "split_gain=", "leaf_value=", "leaf_weight=",
                 "internal_value=", "internal_weight=")
