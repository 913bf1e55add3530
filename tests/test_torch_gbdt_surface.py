"""The rest of the port's GBDT estimator surface against the JAX package's:
prediction windows, leaf indices, TreeSHAP, the JSON dump, validation with
early stopping, warm starts, custom objectives, checkpoint resume and the
three estimators with each of those params.

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``device="cpu"``, where every histogram goes through the
plain PyTorch version of its CUDA kernel. The JAX fits are made once per
module (``jax_fits``). Tolerances, each with its reason:

* tree structure, ``best_iteration`` and stopping points: exact (same
  bins; split decisions from histograms that agree to the last bits);
* leaf values: 1e-5 (float32 sums in another order, as in
  ``test_torch_gbdt_family.py``);
* the validation metric series and ``best_score``: 1e-6 (float32 metrics
  of scores that differ in their last bits);
* a booster carried across by ``convert`` (the same trees): windowed raw
  scores and leaf indices exact, predictions within 1e-6 (the sigmoid or
  softmax of another library), the JSON dump byte-identical, SHAP within
  1e-6 of the largest |phi| (float64 sums in another order);
* resume: bitwise equal to an uninterrupted port fit (one process, one
  device, the same operations).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.core import Table as JTable
from synapseml_tpu.core import assemble_features as j_assemble
from synapseml_tpu.gbdt import boosting as jboost
from synapseml_tpu.gbdt import grower as jgrower
from synapseml_tpu.models import LightGBMClassifier as JClassifier
from synapseml_tpu.models import LightGBMRanker as JRanker
from synapseml_tpu.models import LightGBMRegressor as JRegressor

from synapseml_tpu_torch.convert import booster_arrays, booster_from_reference
from synapseml_tpu_torch.core import Table, assemble_features
from synapseml_tpu_torch.core import checkpoint as tckpt
from synapseml_tpu_torch.gbdt import boosting as tboost
from synapseml_tpu_torch.models import (LightGBMClassifier, LightGBMRanker,
                                        LightGBMRegressor)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
NT, NV, F = 600, 300, 5
LEAF_TOL = 1e-5
METRIC_TOL = 1e-6
BASE = dict(num_iterations=25, num_leaves=7, min_data_in_leaf=5,
            learning_rate=0.5, early_stopping_round=3)


def _data(kind: str, seed: int = 0):
    """(X, y, group sizes or None) of NT + NV rows: noisy labels, so a high
    learning rate overfits and the validation metric turns within a few
    iterations; feature 3 has missing values."""
    rng = np.random.default_rng(seed)
    n = NT + NV
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random(n) < 0.08, 3] = np.nan
    z = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2]
         + 0.9 * rng.normal(size=n)).astype(np.float32)
    groups = None
    if kind == "binary":
        y = (z > 0).astype(np.float32)
    elif kind == "multiclass":
        y = np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    elif kind == "rank":
        y = np.clip(np.digitize(z, [-1, 0, 0.5, 1]), 0, 4).astype(np.float32)
        # 10-row queries: NT and NV are multiples of 10, so both splits
        # stay group-contiguous
        groups = np.full(n // 10, 10)
    else:
        y = z
    return X, y, groups


def _split(X, y, groups):
    """(train args, valid tuple, train kwargs) for train_booster."""
    kw = {}
    valid = (X[NT:], y[NT:])
    if groups is not None:
        kw["group_sizes"] = groups[: NT // 10]
        valid = (X[NT:], y[NT:], None, groups[NT // 10:])
    return (X[:NT], y[:NT]), valid, kw


# (case, data kind, config kwargs): the metrics of every objective family
VALID_CASES = {
    "binary-auc": ("binary", dict(objective="binary", metric="auc")),
    "multiclass-logloss": ("multiclass", dict(objective="multiclass",
                                              num_class=3,
                                              metric="multi_logloss")),
    "regression-rmse": ("regression", dict(objective="regression",
                                           metric="rmse")),
    "regression-l1": ("regression", dict(objective="regression_l1",
                                         metric="l1")),
    "rank-ndcg": ("rank", dict(objective="lambdarank", metric="ndcg",
                               eval_at=(3,))),
    "rank-map": ("rank", dict(objective="lambdarank", metric="map@5")),
    # a new best must beat the last by more than the tolerance
    "binary-tolerance": ("binary", dict(objective="binary", metric="auc",
                                        improvement_tolerance=0.004)),
    # binary_error on 300 rows moves in steps of 1/300: exact ties, where
    # the first best is kept
    "binary-ties": ("binary", dict(objective="binary",
                                   metric="binary_error")),
}
# the metric each case evaluates, where it is not the config's own
METRIC_NAMES = {"rank-ndcg": "ndcg@3"}
POLICIES = ("leafwise", "depthwise")
TIE_FREE = [c for c in VALID_CASES if c not in ("binary-tolerance",
                                                "binary-ties")]
VALID_PARAMS = ([(c, p) for c in TIE_FREE for p in POLICIES]
                + [("binary-tolerance", "leafwise"),
                   ("binary-ties", "leafwise")])


def _fit_pair(case, policy, **extra):
    kind, kw = VALID_CASES[case]
    X, y, groups = _data(kind)
    (Xt, yt), valid, fkw = _split(X, y, groups)
    cfg = dict(BASE, growth_policy=policy, **kw, **extra)
    jb = jboost.train_booster(Xt, yt, jboost.BoosterConfig(**cfg),
                              valid=valid, **fkw)
    tb = tboost.train_booster(Xt, yt, tboost.BoosterConfig(**cfg),
                              valid=valid, device=CPU, **fkw)
    return dict(X=X, y=y, groups=groups, valid=valid, jb=jb, tb=tb, kw=cfg)


@pytest.fixture(scope="module")
def jax_fits():
    """{(case, policy): fit pair} for every validation case, fitted once."""
    return {key: _fit_pair(*key) for key in VALID_PARAMS}


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
                                   rtol=LEAF_TOL, atol=LEAF_TOL)


def _jax_metric(jb, name, valid, iters):
    """The JAX package's metric after each of the first ``iters``
    iterations of its own booster, the validation score summed as its
    training sums it: the base score, then each tree's leaf value in float32
    (one traversal of every tree, then the metric at one shape)."""
    Xv, yv = valid[0], valid[1]
    k = jb.models_per_iter
    per_tree = np.asarray(jgrower.forest_predict(
        jb.forest(), jnp.asarray(Xv), output="per_tree",
        depth=jb._depth_cache))
    score = np.tile(np.asarray(jb.base_score[:k], np.float32), (len(yv), 1))
    transform = jb._objective_for_transform().transform
    out = []
    for i in range(iters):
        for c in range(k):
            score[:, c] += per_tree[:, i * k + c]
        raw = jnp.asarray(score)
        pred = transform(raw[:, 0] if k == 1 else raw)
        out.append(float(jboost._eval_metric(name, yv, pred, raw, valid, k,
                                             jb.config, None)))
    return np.asarray(out)


def _carried(jb):
    arrays, config = booster_arrays(jb)
    return booster_from_reference(arrays, config, device=CPU)


# ---------------------------------------------------------------------------
# validation and early stopping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,policy", VALID_PARAMS)
def test_early_stopping_gives_the_reference_trees_and_best_iteration(
        jax_fits, case, policy):
    fit = jax_fits[case, policy]
    jb, tb = fit["jb"], fit["tb"]
    _same_trees(tb, jb)
    assert tb.best_iteration == jb.best_iteration
    assert abs(tb.best_score - jb.best_score) <= METRIC_TOL
    series = tb.metadata["valid_metric"]
    assert series["name"] == METRIC_NAMES.get(case, fit["kw"].get("metric"))
    values = np.asarray(series["values"])
    # it stopped: early_stopping_round iterations after the best, cut there
    assert len(values) < BASE["num_iterations"]
    assert len(values) - 1 - tb.best_iteration == BASE["early_stopping_round"]
    assert tb.num_trees == (tb.best_iteration + 1) * tb.models_per_iter
    want = _jax_metric(jb, series["name"], fit["valid"],
                       tb.best_iteration + 1)
    np.testing.assert_allclose(values[:len(want)], want, rtol=0,
                               atol=METRIC_TOL)
    # the best is the first one that beats every earlier value by more than
    # the tolerance
    higher = series["name"].split("@")[0] in tboost.HIGHER_IS_BETTER
    signed = values if higher else -values
    bests = jboost._best_so_far(signed, fit["kw"].get(
        "improvement_tolerance", 0.0))
    assert int(bests[-1]) == tb.best_iteration
    assert tb.best_score == values[tb.best_iteration]


def test_ties_keep_the_first_best(jax_fits):
    values = np.asarray(
        jax_fits["binary-ties", "leafwise"]["tb"].metadata["valid_metric"]
        ["values"])
    best = jax_fits["binary-ties", "leafwise"]["tb"].best_iteration
    # the stop came after early_stopping_round iterations none of which
    # beat the best; a tie among them did not move it
    assert values[best] == values[best:].min()
    assert (values[best + 1:] == values[best]).any()


def test_tolerance_moves_the_best_iteration(jax_fits):
    tol = jax_fits["binary-tolerance", "leafwise"]["tb"]
    plain = jax_fits["binary-auc", "leafwise"]["tb"]
    assert tol.best_iteration < plain.best_iteration


def test_validation_without_early_stopping_keeps_every_tree():
    fit = _fit_pair("binary-auc", "leafwise", early_stopping_round=0,
                    num_iterations=6)
    _same_trees(fit["tb"], fit["jb"])
    assert fit["tb"].num_trees == 6
    assert fit["tb"].best_iteration == fit["jb"].best_iteration
    assert abs(fit["tb"].best_score - fit["jb"].best_score) <= METRIC_TOL


def test_validation_weights_weight_the_metric():
    X, y, _ = _data("regression")
    w = np.linspace(0.5, 2.0, NV).astype(np.float32)
    cfg = dict(BASE, objective="regression", metric="l2",
               num_iterations=4, early_stopping_round=0)
    valid = (X[NT:], y[NT:], w)
    tb = tboost.train_booster(X[:NT], y[:NT], tboost.BoosterConfig(**cfg),
                              valid=valid, device=CPU)
    jb = jboost.train_booster(X[:NT], y[:NT], jboost.BoosterConfig(**cfg),
                              valid=valid)
    assert abs(tb.best_score - jb.best_score) <= METRIC_TOL
    raw = tb.raw_score(X[NT:])
    want = float((w * (y[NT:] - raw) ** 2).sum() / w.sum())
    assert abs(tb.metadata["valid_metric"]["values"][-1] - want) <= 1e-5


def test_validation_costs_one_host_sync_per_iteration():
    X, y, _ = _data("binary")
    cfg = tboost.BoosterConfig(objective="binary", num_iterations=3,
                               num_leaves=7, min_data_in_leaf=5)
    plain = tboost.train_booster(X[:NT], y[:NT], cfg, device=CPU)
    with_valid = tboost.train_booster(X[:NT], y[:NT], cfg, device=CPU,
                                      valid=(X[NT:], y[NT:]))
    assert (with_valid.metadata["host_syncs"]
            == plain.metadata["host_syncs"] + 3)


def test_unknown_metric_and_ranking_without_groups_raise():
    X, y, groups = _data("rank")
    (Xt, yt), valid, kw = _split(X, y, groups)
    cfg = tboost.BoosterConfig(objective="lambdarank", num_iterations=1)
    with pytest.raises(ValueError, match="group_sizes_v"):
        tboost.train_booster(Xt, yt, cfg, valid=valid[:2], device=CPU, **kw)
    with pytest.raises(ValueError, match="unknown metric"):
        tboost.train_booster(Xt, yt, tboost.BoosterConfig(
            objective="binary", metric="nope", num_iterations=1),
            valid=valid, device=CPU)


# ---------------------------------------------------------------------------
# prediction windows, leaf indices, SHAP and the JSON dump on carried
# boosters (the same trees in both packages)
# ---------------------------------------------------------------------------

SURFACE_CASES = ["binary-auc", "multiclass-logloss", "rank-ndcg"]
WINDOWS = [(0, -1), (2, -1), (1, 3), (0, 2), (40, -1)]


@pytest.mark.parametrize("case", SURFACE_CASES)
def test_windowed_raw_score_and_leaves_equal_the_reference(jax_fits, case):
    fit = jax_fits[case, "leafwise"]
    jb, X = fit["jb"], fit["X"]
    tb = _carried(jb)
    for start, num in WINDOWS:
        np.testing.assert_array_equal(
            tb.raw_score(X, num_iteration=num, start_iteration=start),
            np.asarray(jb.raw_score(X, num_iteration=num,
                                    start_iteration=start)))
    # the transform (sigmoid, softmax) of another library: 1e-6
    np.testing.assert_allclose(tb.predict(X, num_iteration=2),
                               np.asarray(jb.predict(X, num_iteration=2)),
                               rtol=1e-6, atol=1e-6)
    leaves = tb.predict_leaf(X)
    assert leaves.shape == (len(X), jb.num_trees) and leaves.dtype == np.int32
    np.testing.assert_array_equal(leaves, np.asarray(jb.predict_leaf(X)))
    for start in (1, 2):
        tb.config.start_iteration = jb.config.start_iteration = start
        try:
            np.testing.assert_array_equal(tb.predict_leaf(X),
                                          np.asarray(jb.predict_leaf(X)))
            np.testing.assert_array_equal(tb.raw_score(X),
                                          np.asarray(jb.raw_score(X)))
        finally:
            tb.config.start_iteration = jb.config.start_iteration = 0


@pytest.mark.parametrize("case", SURFACE_CASES)
def test_leaf_indices_pick_the_raw_score(jax_fits, case):
    tb = jax_fits[case, "leafwise"]["tb"]
    X = jax_fits[case, "leafwise"]["X"]
    k = tb.models_per_iter
    leaves = tb.predict_leaf(X)
    picked = np.stack([np.asarray(tb.trees[t].leaf_value)[leaves[:, t]]
                       for t in range(tb.num_trees)], 1)
    raw = (picked.reshape(len(X), -1, k).sum(1)
           + tb.base_score[None, :k]).reshape(tb.raw_score(X).shape)
    np.testing.assert_allclose(raw, tb.raw_score(X), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", SURFACE_CASES)
def test_shap_matches_the_reference(jax_fits, case):
    fit = jax_fits[case, "leafwise"]
    jb, X = fit["jb"], fit["X"][NT:NT + 40]
    tb = _carried(jb)
    want = np.asarray(jb.feature_shap(X))
    got = tb.feature_shap(X)
    k = tb.models_per_iter
    assert got.shape == (len(X), k * (F + 1))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # each class block sums to that class's raw score
    raw = tb.raw_score(X).reshape(len(X), k)
    np.testing.assert_allclose(got.reshape(len(X), k, F + 1).sum(2), raw,
                               rtol=0, atol=1e-5)
    # the prediction window drops the leading iterations' trees
    tb.config.start_iteration = jb.config.start_iteration = 2
    try:
        np.testing.assert_allclose(tb.feature_shap(X),
                                   np.asarray(jb.feature_shap(X)), rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    finally:
        tb.config.start_iteration = jb.config.start_iteration = 0


@pytest.mark.parametrize("case", SURFACE_CASES)
def test_json_dump_is_byte_identical(jax_fits, case):
    fit = jax_fits[case, "leafwise"]
    jb, tb = fit["jb"], fit["tb"]
    assert _carried(jb).dump_model() == jb.dump_model()
    assert _carried(jb).dump_model(2) == jb.dump_model(2)
    # the port's own fit: the same structure, numbers within 1e-6
    got, want = json.loads(tb.dump_model()), json.loads(jb.dump_model())

    def walk(a, b, path=""):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for key in a:
                walk(a[key], b[key], f"{path}.{key}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, z) in enumerate(zip(a, b)):
                walk(x, z, f"{path}[{i}]")
        elif isinstance(a, float):
            assert abs(a - b) <= 1e-6 * max(1.0, abs(b)) + LEAF_TOL, path
        else:
            assert a == b, path

    walk(got, want)


# ---------------------------------------------------------------------------
# warm starts, custom objectives, resume
# ---------------------------------------------------------------------------

def _warm_data():
    X, y, _ = _data("binary", seed=5)
    return X[:NT], y[:NT], (X[NT:], y[NT:])


def test_warm_start_from_a_booster_and_a_model_string(jax_fits):
    init_j = jax_fits["binary-auc", "leafwise"]["jb"]
    init_t = _carried(init_j)
    X, y, valid = _warm_data()
    cfg = dict(BASE, objective="binary", num_iterations=6)
    text = init_j.model_string()
    for jinit, tinit in ((init_j, init_t),
                         (jboost.Booster.from_model_string(text),
                          tboost.Booster.from_model_string(text,
                                                           device=CPU))):
        jb = jboost.train_booster(X, y, jboost.BoosterConfig(**cfg),
                                  init_model=jinit, valid=valid)
        tb = tboost.train_booster(X, y, tboost.BoosterConfig(**cfg),
                                  init_model=tinit, valid=valid, device=CPU)
        n0 = init_j.num_trees
        _same_trees(tb, jb, start=n0)
        assert tb.best_iteration == jb.best_iteration
        assert tb.best_iteration >= n0
        assert abs(tb.best_score - jb.best_score) <= METRIC_TOL
        # the init trees keep their own thresholds and structure
        for i in range(n0):
            np.testing.assert_array_equal(tb._thresholds(i),
                                          tinit._thresholds(i))
            np.testing.assert_array_equal(tb.trees[i].split_feature,
                                          tinit.trees[i].split_feature)
        np.testing.assert_allclose(tb.raw_score(X),
                                   np.asarray(jb.raw_score(X)), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(
            tboost.Booster.from_model_string(tb.model_string(),
                                             device=CPU).raw_score(X),
            tb.raw_score(X), rtol=0, atol=1e-5)


def test_custom_objective_gives_the_reference_trees():
    X, y, valid = _warm_data()

    def t_logistic(score, label, weight):
        p = torch.sigmoid(score)
        return (p - label) * weight, p * (1 - p) * weight

    def j_logistic(score, label, weight):
        p = 1.0 / (1.0 + jnp.exp(-score))
        return (p - label) * weight, p * (1 - p) * weight

    cfg = dict(BASE, objective="binary", num_iterations=5)
    jb = jboost.train_booster(X, y, jboost.BoosterConfig(**cfg),
                              fobj=j_logistic, valid=valid)
    tb = tboost.train_booster(X, y, tboost.BoosterConfig(**cfg),
                              fobj=t_logistic, valid=valid, device=CPU)
    _same_trees(tb, jb)
    assert tb.best_iteration == jb.best_iteration

    def wrong(score, label, weight):
        return score[:-1], score

    with pytest.raises(ValueError, match="fobj returned grad"):
        tboost.train_booster(X, y, tboost.BoosterConfig(**cfg), fobj=wrong,
                             device=CPU)


def _stop_after(iteration):
    def cb(it, trees):
        if it == iteration:
            raise tckpt.PreemptionError(f"stopped after {it}")
    return cb


@pytest.mark.parametrize("policy", POLICIES)
def test_resume_after_preemption_is_bitwise_the_uninterrupted_fit(
        tmp_path, policy):
    X, y, valid = _warm_data()
    cfg = tboost.BoosterConfig(**dict(BASE, objective="binary",
                                      num_iterations=8, growth_policy=policy,
                                      early_stopping_round=0))
    full = tboost.train_booster(X, y, cfg, valid=valid, device=CPU)
    store = str(tmp_path / "ckpt")
    saved = {}

    def keep(it, trees):
        if it == 3:
            saved["trees"] = [t for t in tboost.trees_to_host(trees)]

    with pytest.raises(tckpt.PreemptionError):
        tboost.train_booster(X, y, cfg, valid=valid, device=CPU,
                             checkpoint_store=store, checkpoint_every=2,
                             callbacks=[keep, _stop_after(4)])
    assert tckpt.CheckpointStore(store).latest_step() == 4
    resumed = tboost.train_booster(X, y, cfg, valid=valid, device=CPU,
                                   checkpoint_store=store, checkpoint_every=2)
    assert resumed.num_trees == full.num_trees
    for a, b in zip(resumed.trees, full.trees):
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))
    for a, b in zip(resumed.trees[:4], saved["trees"]):
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    np.testing.assert_array_equal(resumed.raw_score(X), full.raw_score(X))
    assert resumed.best_iteration == full.best_iteration
    assert resumed.best_score == full.best_score
    assert (resumed.metadata["valid_metric"]["values"]
            == full.metadata["valid_metric"]["values"])
    # a snapshot of another run is not resumed from
    other = tboost.BoosterConfig(**dict(vars(cfg), learning_rate=0.3))
    fresh = tboost.train_booster(X, y, other, device=CPU,
                                 checkpoint_store=store, checkpoint_every=2)
    assert fresh.metadata["measures"]["count:iterations"] == 8


def test_checkpoint_store_falls_back_past_a_corrupt_snapshot(tmp_path):
    from synapseml_tpu_torch.core.logging import (failure_counts,
                                                  reset_failure_counts)

    store = tckpt.CheckpointStore(str(tmp_path), keep_last=2)
    store.save(1, {"a.bin": b"one"})
    store.save(2, {"a.bin": b"two"})
    store.save(3, {"a.bin": b"three"})
    assert store.steps() == [2, 3]
    with open(tmp_path / "ckpt_00000003.a.bin", "wb") as f:
        f.write(b"thrEe")
    reset_failure_counts()
    ckpt = store.load_latest()
    assert ckpt.step == 2 and ckpt.artifacts["a.bin"] == b"two"
    counts = failure_counts()
    assert counts["checkpoint.corrupt"] == 1
    assert counts["checkpoint.fallback"] == 1


# ---------------------------------------------------------------------------
# the estimators
# ---------------------------------------------------------------------------

def _tables(X, y, extra):
    cols = {f"f{i}": X[:, i] for i in range(X.shape[1])}
    cols.update(label=y, **extra)
    names = [f"f{i}" for i in range(X.shape[1])]
    return (assemble_features(Table(dict(cols)), names),
            j_assemble(JTable(dict(cols)), names))


def _is_val(n):
    flag = np.zeros(n, bool)
    flag[NT:] = True
    return flag


COMMON = dict(numIterations=25, numLeaves=7, minDataInLeaf=5,
              learningRate=0.5, earlyStoppingRound=3,
              validationIndicatorCol="isVal", leafPredictionCol="leaves",
              featuresShapCol="shap")


def _compare_models(tm, jm, tt, jt, cols):
    _same_trees(tm.booster, jm.booster)
    assert tm.getBoosterBestIteration() == jm.getBoosterBestIteration()
    assert abs(tm.getBoosterBestScore() - jm.getBoosterBestScore()) \
        <= METRIC_TOL
    tout, jout = tm.transform(tt), jm.transform(jt)
    for col in cols:
        np.testing.assert_allclose(tout[col], jout[col], rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(tout["leaves"], jout["leaves"])
    shap_j = np.asarray(jout["shap"])
    assert np.abs(tout["shap"] - shap_j).max() <= 1e-5 * np.abs(shap_j).max()
    got, want = json.loads(tm.dumpModel()), json.loads(jm.dumpModel())
    assert len(got["tree_info"]) == len(want["tree_info"])
    return tout


def test_classifier_with_every_ported_param():
    X, y, _ = _data("binary", seed=3)
    tt, jt = _tables(X, y, {"isVal": _is_val(len(y))})
    params = dict(COMMON, metric="binary_logloss", improvementTolerance=1e-4,
                  startIteration=1)
    tm = LightGBMClassifier(device=CPU, **params).fit(tt)
    jm = JClassifier(**params).fit(jt)
    out = _compare_models(tm, jm, tt, jt, ("probability", "rawPrediction"))
    assert out["leaves"].shape == (len(y), tm.booster.num_trees - 1)
    np.testing.assert_allclose(
        tm.getFeatureShaps(X[:8]), np.asarray(jm.getFeatureShaps(X[:8])),
        rtol=0, atol=1e-5)
    # warm start from the model string, in two batches
    warm = dict(numIterations=4, numLeaves=7, minDataInLeaf=5,
                learningRate=0.5, numBatches=2,
                modelString=jm.getNativeModel())
    tw = LightGBMClassifier(device=CPU, **warm).fit(tt)
    jw = JClassifier(**warm).fit(jt)
    n0 = jm.booster.num_trees
    assert tw.booster.num_trees == n0 + 8
    _same_trees(tw.booster, jw.booster, start=n0)
    np.testing.assert_allclose(tw.transform(tt)["probability"],
                               jw.transform(jt)["probability"], rtol=1e-5,
                               atol=1e-5)


def test_regressor_with_every_ported_param():
    X, y, _ = _data("regression", seed=4)
    tt, jt = _tables(X, y, {"isVal": _is_val(len(y))})

    def t_l2(score, label, weight):
        return (score - label) * weight, weight

    def j_l2(score, label, weight):
        return (score - label) * weight, weight

    params = dict(COMMON, metric="l2", improvementTolerance=1e-3,
                  startIteration=1)
    tm = LightGBMRegressor(device=CPU, fobj=t_l2, **params).fit(tt)
    jm = JRegressor(fobj=j_l2, **params).fit(jt)
    _compare_models(tm, jm, tt, jt, ("prediction",))


def test_ranker_with_every_ported_param():
    X, y, groups = _data("rank", seed=6)
    gid = np.repeat(np.arange(len(groups)), groups)
    tt, jt = _tables(X, y, {"isVal": _is_val(len(y)), "group": gid})
    params = dict(COMMON, groupCol="group", metric="map", evalAt=[3],
                  maxPosition=5, improvementTolerance=1e-3, startIteration=1)
    tm = LightGBMRanker(device=CPU, **params).fit(tt)
    jm = JRanker(**params).fit(jt)
    _compare_models(tm, jm, tt, jt, ("prediction",))
    with pytest.raises(NotImplementedError, match="numBatches"):
        LightGBMRanker(device=CPU, groupCol="group", numIterations=1,
                       numBatches=2).fit(tt)
