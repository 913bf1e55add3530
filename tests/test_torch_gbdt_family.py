"""The port's objective family end to end against the JAX package's:
``train_booster`` for regression, multiclass, multiclassova and lambdarank
under both growth policies, the three estimators, and boosters carried
across by ``convert``.

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``device="cpu"``, where every histogram goes through the
plain PyTorch version of its CUDA kernel. Tolerances, each with its reason:

* tree structure: exact (same bins; split decisions from histograms that
  agree to the last bits);
* leaf values and predictions of ``train_booster``: 1e-5 (float32 sums in
  another order; the lambdarank gradients sum pair terms of another
  library's sigmoid and log2); the estimators' predictions and
  probabilities: 1e-6;
* class predictions: identical;
* a booster carried across: byte-identical model string, reload within
  1e-5.
"""

import numpy as np
import pytest

from synapseml_tpu.core import Table as JTable
from synapseml_tpu.core import assemble_features as j_assemble
from synapseml_tpu.gbdt import boosting as jboost
from synapseml_tpu.models import LightGBMClassifier as JClassifier
from synapseml_tpu.models import LightGBMRanker as JRanker
from synapseml_tpu.models import LightGBMRegressor as JRegressor

from synapseml_tpu_torch.convert import booster_arrays, booster_from_reference
from synapseml_tpu_torch.core import PipelineStage, Table, assemble_features
from synapseml_tpu_torch.gbdt import boosting as tboost
from synapseml_tpu_torch.models import (LightGBMClassifier, LightGBMRanker,
                                        LightGBMRegressor)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
N, F = 2000, 6
TOL = 1e-5


def _features(n=N, f=F, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.random(n) < 0.05, 4] = np.nan              # a column with NaN
    z = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] + 0.2 * rng.normal(size=n)
    return X, z.astype(np.float32), rng


def _group_sizes(rng, n, gmax=30):
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.integers(1, gmax + 1)))
    sizes[-1] -= sum(sizes) - n
    return np.asarray([s for s in sizes if s > 0])


def _case(objective):
    """(X, y, config kwargs, train_booster kwargs) of one objective."""
    X, z, rng = _features(seed=len(objective))
    kw = dict(objective=objective, num_iterations=3, num_leaves=15,
              min_data_in_leaf=10)
    extra = {}
    if objective in ("multiclass", "multiclassova"):
        kw["num_class"] = 3
        y = np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    elif objective == "lambdarank":
        kw["label_gain"] = (0.0, 1.0, 3.0, 7.0, 15.0)
        y = np.clip(np.digitize(z, [-1, 0, 0.5, 1]), 0, 4).astype(np.float32)
        extra["group_sizes"] = _group_sizes(rng, N)
    else:
        y = z
    return X, y, kw, extra


def _same_trees(tb, jb):
    assert tb.num_trees == jb.num_trees
    assert tb.models_per_iter == jb.models_per_iter
    for tt, jt in zip(tb.trees, jb.trees):
        ns = int(tt.num_splits)
        assert ns == int(jt.num_splits)
        for f in ("split_feature", "split_bin", "default_left", "left_child",
                  "right_child"):
            np.testing.assert_array_equal(np.asarray(getattr(tt, f))[:ns],
                                          np.asarray(getattr(jt, f))[:ns])
        np.testing.assert_allclose(tt.leaf_value[:ns + 1],
                                   np.asarray(jt.leaf_value)[:ns + 1],
                                   rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def fits():
    """{(objective, policy): (X, jax booster, port booster)}, fitted once."""
    out = {}
    for objective in ("regression", "multiclass", "multiclassova",
                      "lambdarank"):
        X, y, kw, extra = _case(objective)
        for policy in ("leafwise", "depthwise"):
            jb = jboost.train_booster(
                X, y, jboost.BoosterConfig(growth_policy=policy, **kw),
                **extra)
            tb = tboost.train_booster(
                X, y, tboost.BoosterConfig(growth_policy=policy, **kw),
                device=CPU, **extra)
            out[objective, policy] = (X, jb, tb)
    return out


CASES = [(o, p) for o in ("regression", "multiclass", "multiclassova",
                          "lambdarank") for p in ("leafwise", "depthwise")]


@pytest.mark.parametrize("objective,policy", CASES)
def test_train_booster_gives_the_reference_trees(fits, objective, policy):
    X, jb, tb = fits[objective, policy]
    _same_trees(tb, jb)
    np.testing.assert_allclose(tb.base_score, jb.base_score, rtol=1e-6,
                               atol=2e-6)
    raw = tb.raw_score(X)
    assert raw.shape == np.asarray(jb.raw_score(X)).shape
    np.testing.assert_allclose(raw, jb.raw_score(X), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("objective,policy", CASES)
def test_booster_from_reference_is_byte_identical(fits, objective, policy):
    X, jb, _ = fits[objective, policy]
    arrays, config = booster_arrays(jb)
    tb = booster_from_reference(arrays, config, device=CPU)
    assert tb.model_string() == jb.model_string()
    assert tb.models_per_iter == jb.models_per_iter
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=TOL,
                               atol=TOL)
    # and back through the port's own model-string parser
    loaded = tboost.Booster.from_model_string(tb.model_string(), device=CPU)
    assert loaded.num_class == jb.num_class
    np.testing.assert_allclose(loaded.predict(X), jb.predict(X), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("objective,params", [
    ("huber", dict(alpha=0.7)), ("fair", dict(fair_c=0.5)),
    ("poisson", dict(poisson_max_delta_step=0.4)),
    ("quantile", dict(alpha=0.25)),
    ("tweedie", dict(tweedie_variance_power=1.3)),
    ("multiclassova", dict(num_class=3, sigmoid=1.5)),
])
def test_model_string_keeps_the_objective_params(objective, params):
    X, z, _ = _features(n=400)
    y = (np.digitize(z, [-0.5, 0.5]) if objective == "multiclassova"
         else np.floor(np.exp(z)) if objective in ("poisson", "tweedie")
         else z).astype(np.float32)
    cfg = dict(objective=objective, num_iterations=2, num_leaves=4,
               min_data_in_leaf=5, **params)
    tb = tboost.train_booster(X, y, tboost.BoosterConfig(**cfg), device=CPU)
    jb = jboost.train_booster(X, y, jboost.BoosterConfig(**cfg))
    # the header up to the tree sizes (objective string included) is the
    # reference's; leaf values print 17 digits of float32 sums taken in
    # another order, and the tree sizes count those digits
    head = tb.model_string().split("\ntree_sizes=")[0]
    assert head == jb.model_string().split("\ntree_sizes=")[0]
    carried = booster_from_reference(*booster_arrays(jb), device=CPU)
    assert carried.model_string() == jb.model_string()
    loaded = tboost.Booster.from_model_string(tb.model_string(), device=CPU)
    for name, value in params.items():
        assert getattr(loaded.config, name) == pytest.approx(value)
    np.testing.assert_allclose(loaded.predict(X), tb.predict(X), rtol=TOL,
                               atol=TOL)


def test_lambdarank_checks_its_inputs():
    X, y, kw, extra = _case("lambdarank")
    with pytest.raises(ValueError, match="group_sizes"):
        tboost.train_booster(X, y, tboost.BoosterConfig(**kw), device=CPU)
    kw["label_gain"] = (0.0, 1.0)
    with pytest.raises(ValueError, match="label_gain"):
        tboost.train_booster(X, y, tboost.BoosterConfig(**kw), device=CPU,
                             **extra)


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------

def _tables(X, cols):
    names = [f"f{i}" for i in range(X.shape[1])]
    data = {**{n: X[:, i] for i, n in enumerate(names)}, **cols}
    return (assemble_features(Table(dict(data)), names),
            j_assemble(JTable(dict(data)), names))


def test_multiclass_classifier_matches_reference(tmp_path):
    X, z, _ = _features(seed=5)
    labels = np.asarray([10.0, 20.0, 35.0, 50.0])[
        np.digitize(z, [-0.7, 0.0, 0.7])]             # 4 arbitrary values
    tt, jt = _tables(X, {"label": labels})
    params = dict(numIterations=3, numLeaves=15, thresholds=[1.0, 0.5, 1.0,
                                                             2.0])
    model = LightGBMClassifier(device=CPU, **params).fit(tt)
    tout = model.transform(tt)
    jout = JClassifier(**params).fit(jt).transform(jt)
    assert model.getBoosterNumClasses() == 4
    assert model.getBoosterNumTotalModel() == 12
    assert tout["probability"].shape == (N, 4)
    np.testing.assert_allclose(tout["probability"], jout["probability"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tout["rawPrediction"], jout["rawPrediction"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tout["prediction"], jout["prediction"])
    assert set(np.unique(tout["prediction"])) <= {10.0, 20.0, 35.0, 50.0}
    model.save(str(tmp_path / "stage"))
    again = PipelineStage.load(str(tmp_path / "stage")).transform(tt)
    np.testing.assert_array_equal(again["prediction"], tout["prediction"])
    np.testing.assert_allclose(again["probability"], tout["probability"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("objective", ["multiclassova", "multiclass"])
def test_classifier_objective_on_two_classes_matches_reference(objective):
    X, z, _ = _features(n=800, seed=6)
    tt, jt = _tables(X, {"label": (z > 0).astype(np.float32)})
    params = dict(numIterations=2, numLeaves=7, objective=objective)
    tout = LightGBMClassifier(device=CPU, **params).fit(tt).transform(tt)
    jout = JClassifier(**params).fit(jt).transform(jt)
    assert tout["probability"].shape == (800, 2)
    np.testing.assert_allclose(tout["probability"], jout["probability"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tout["prediction"], jout["prediction"])


@pytest.mark.parametrize("objective,params", [
    ("regression", {}), ("quantile", {"alpha": 0.3}),
    ("tweedie", {"tweedieVariancePower": 1.4}), ("huber", {"alpha": 0.8}),
])
def test_regressor_matches_reference(tmp_path, objective, params):
    X, z, _ = _features(seed=7)
    y = (np.floor(np.exp(z)) if objective == "tweedie" else z)
    tt, jt = _tables(X, {"label": y.astype(np.float32)})
    kw = dict(numIterations=3, numLeaves=15, objective=objective, **params)
    model = LightGBMRegressor(device=CPU, **kw).fit(tt)
    tout = model.transform(tt)
    jout = JRegressor(**kw).fit(jt).transform(jt)
    np.testing.assert_allclose(tout["prediction"], jout["prediction"],
                               rtol=1e-6, atol=1e-6)
    model.saveNativeModel(str(tmp_path / "model.txt"))
    loaded = tboost.Booster.from_model_string(
        (tmp_path / "model.txt").read_text(), device=CPU)
    np.testing.assert_allclose(loaded.predict(X), tout["prediction"],
                               rtol=TOL, atol=TOL)
    model.save(str(tmp_path / "stage"))
    again = PipelineStage.load(str(tmp_path / "stage")).transform(tt)
    np.testing.assert_allclose(again["prediction"], tout["prediction"],
                               rtol=1e-6, atol=1e-6)


def test_ranker_matches_reference(tmp_path):
    X, z, rng = _features(seed=8)
    sizes = _group_sizes(rng, N)
    group = np.repeat(np.arange(len(sizes)), sizes)
    perm = rng.permutation(N)                       # groups not contiguous
    y = np.clip(np.digitize(z, [-1, 0, 0.5, 1]), 0, 4).astype(np.float32)
    tt, jt = _tables(X[perm], {"label": y[perm],
                               "query": group[perm].astype(np.int64)})
    kw = dict(numIterations=3, numLeaves=15, groupCol="query", maxPosition=8,
              labelGain=[0.0, 1.0, 3.0, 7.0, 15.0], evalAt=[1, 3])
    model = LightGBMRanker(device=CPU, **kw).fit(tt)
    jmodel = JRanker(**kw).fit(jt)
    _same_trees(model.booster, jmodel.booster)
    cfg = model.booster.config
    assert cfg.objective == "lambdarank"
    assert cfg.lambdarank_truncation_level == 8
    assert cfg.label_gain == (0.0, 1.0, 3.0, 7.0, 15.0)
    assert cfg.eval_at == (1, 3)
    tout = model.transform(tt)
    np.testing.assert_allclose(tout["prediction"],
                               jmodel.transform(jt)["prediction"], rtol=1e-6,
                               atol=1e-6)
    model.save(str(tmp_path / "stage"))
    again = PipelineStage.load(str(tmp_path / "stage")).transform(tt)
    np.testing.assert_allclose(again["prediction"], tout["prediction"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cls,jcls", [(LightGBMRegressor, JRegressor),
                                      (LightGBMRanker, JRanker)])
def test_estimators_refuse_unported_params_by_name(cls, jcls):
    """Every param of the JAX estimator is ported: ``topK`` and
    ``parallelism``, once refused by name, map to the config's
    ``top_k`` and ``tree_learner`` as the JAX estimator maps them (without
    a mesh every learner trains the serial trees)."""
    from synapseml_tpu_torch.models.gbdt import UNPORTED_PARAMS

    assert set(jcls()._params) - set(cls(device=CPU)._params) \
        == set(UNPORTED_PARAMS) == set()
    for value in ("data_parallel", "voting_parallel", "feature_parallel",
                  "auto"):
        got = cls(device=CPU, topK=10, parallelism=value)._base_config()
        want = jcls(topK=10, parallelism=value)._base_config()
        assert (got.tree_learner, got.top_k) \
            == (want.tree_learner, want.top_k) != (None, None)
        assert cls(device=CPU).set("parallelism", value).getParallelism() \
            == value
