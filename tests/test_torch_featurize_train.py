"""The port's featurization and train helpers (``synapseml_tpu_torch/
featurize``, ``train``) against the JAX package's, on the CPU:

* every featurize and train scenario of ``tests/test_featurize_train_automl.py``
  on the port (its AutoML scenarios are in ``test_torch_automl.py``);
* the same seeded numpy inputs through both packages: ``Featurize``,
  ``CleanMissingData``, the indexers, ``CountSelector``, ``DataConversion``,
  ``TextFeaturizer`` (the native and the Python path), ``MultiNGram`` and
  ``PageSplitter`` bitwise, the metrics bitwise in float64;
* ``TrainClassifier`` / ``TrainRegressor`` on ``device="cpu"`` grow the JAX
  package's trees (the same splits, leaf values within ``LEAF_TOL``), and a
  fit in one of three threads gives the same model string as alone;
* a ``TrainedClassifierModel``, ``FeaturizeModel`` and ``ValueIndexerModel``
  saved by the JAX package load in the port (``_stage_class``) with their
  inner LightGBM model and score within ``LOAD_TOL``.
"""

import threading

import numpy as np
import pytest

from synapseml_tpu import featurize as jfeat
from synapseml_tpu import train as jtrain
from synapseml_tpu.core.table import Table as JTable
from synapseml_tpu.models import LightGBMClassifier as JLGBMClassifier
from synapseml_tpu.models import LightGBMRegressor as JLGBMRegressor

from synapseml_tpu_torch import featurize as tfeat
from synapseml_tpu_torch import train as ttrain
from synapseml_tpu_torch.core.pipeline import PipelineStage
from synapseml_tpu_torch.core.table import Table
from synapseml_tpu_torch.models import LightGBMClassifier, LightGBMRegressor
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)
from torch_waits import join_threads

CPU = "cpu"
# float32 leaf values from sums in another order (the GBDT parity tests'
# bound, tests/test_torch_gbdt.py)
LEAF_TOL = 1e-5
# a JAX-saved model scored by the port: the same trees, another sigmoid
LOAD_TOL = 1e-6
# the regressor's leaf values: its init score (the float32 label mean) may
# differ by one ulp between the packages (summed in another order; the
# objectives' INIT_ATOL), and the histograms round each gradient to bf16, so
# that ulp can move a residual across a bf16 rounding boundary: one bf16 ulp
# (2^-8 of the residual) in one row's gradient. On this table one leaf of 56
# moved by 3.6e-05 (1.6e-04 of its value); the splits stay identical
REGRESSOR_LEAF_TOL = 2.0 ** -8 * 0.1


def _mixed_columns(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "num": rng.normal(size=n).astype(np.float32),
        "missing": np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n)),
        "cat": rng.choice(["a", "b", "c"], size=n).astype(object),
        "label": (rng.random(n) > 0.5).astype(np.float32),
    }


def _mixed_df(n=60, seed=0):
    return Table(_mixed_columns(n, seed))


def _adult_like(n=600, seed=0):
    """An Adult-Census-shaped table at a small size: numerics with a
    missing value, strings with ``"?"``, a string label."""
    rng = np.random.default_rng(seed)
    age = rng.integers(17, 90, size=n).astype(np.float64)
    hours = rng.integers(1, 99, size=n).astype(np.float64)
    hours[rng.random(n) < 0.05] = np.nan
    work = rng.choice(["Private", "Self-emp", "Gov", "?"], size=n)
    edu = rng.choice([f"e{i}" for i in range(16)], size=n)
    sex = rng.choice(["Male", "Female"], size=n)
    country = np.array([f"c{i}" for i in rng.integers(0, 300, size=n)])
    margin = (age - 40) / 12 + (edu == "e15") * 1.5 + (sex == "Male") * 0.5 \
        + rng.normal(size=n)
    label = np.where(margin > 0.8, ">50K", "<=50K")
    return {"age": age, "hours-per-week": hours,
            "workclass": work.astype(object), "education": edu.astype(object),
            "sex": sex.astype(object), "native-country": country.astype(object),
            "income": label.astype(object)}


def _same_trees(tb, jb, leaf_tol=LEAF_TOL):
    assert tb.num_trees == jb.num_trees
    for tt, jt in zip(tb.trees, jb.trees):
        ns = int(tt.num_splits)
        assert ns == int(jt.num_splits)
        for f in ("split_feature", "split_bin", "default_left", "left_child",
                  "right_child"):
            np.testing.assert_array_equal(np.asarray(getattr(tt, f))[:ns],
                                          np.asarray(getattr(jt, f))[:ns])
        np.testing.assert_allclose(np.asarray(tt.leaf_value)[:ns + 1],
                                   np.asarray(jt.leaf_value)[:ns + 1],
                                   rtol=leaf_tol, atol=leaf_tol)


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == object:
        assert list(got.ravel()) == list(want.ravel())
    else:
        assert np.ascontiguousarray(got).tobytes() \
            == np.ascontiguousarray(want).tobytes()


# ---------------------------------------------------------------------------
# the JAX package's scenarios, on the port
# ---------------------------------------------------------------------------

def test_featurize_mixed_types():
    df = _mixed_df()
    model = tfeat.Featurize(inputCols=["num", "missing", "cat"]).fit(df)
    out = model.transform(df)
    X = out["features"]
    assert X.shape == (60, 1 + 1 + 3)  # num + missing + 3 one-hot levels
    assert np.isfinite(X).all()        # NaNs imputed
    assert model.feature_dim == 5


def test_featurize_high_cardinality_hashes():
    df = Table({"id": np.array([f"user{i}" for i in range(50)], object)})
    model = tfeat.Featurize(inputCols=["id"], numFeatures=16).fit(df)
    assert model.transform(df)["features"].shape == (50, 16)


def test_clean_missing_data_modes():
    df = Table({"x": np.array([1.0, np.nan, 3.0, np.nan], np.float64)})
    mean = tfeat.CleanMissingData(inputCols=["x"]).fit(df).transform(df)
    np.testing.assert_allclose(mean["x"], [1, 2, 3, 2])
    med = tfeat.CleanMissingData(inputCols=["x"],
                                 cleaningMode="Median").fit(df).transform(df)
    np.testing.assert_allclose(med["x"], [1, 2, 3, 2])
    cust = tfeat.CleanMissingData(inputCols=["x"], cleaningMode="Custom",
                                  customValue=-1.0).fit(df).transform(df)
    np.testing.assert_allclose(cust["x"], [1, -1, 3, -1])


def test_value_indexer_round_trip():
    df = Table({"c": np.array(["b", "a", "c", "a"], object)})
    model = tfeat.ValueIndexer(inputCol="c", outputCol="ci").fit(df)
    out = model.transform(df)
    np.testing.assert_array_equal(out["ci"], [1, 0, 2, 0])
    back = tfeat.IndexToValue(inputCol="ci", outputCol="cv",
                              levels=model.levels).transform(out)
    assert list(back["cv"]) == ["b", "a", "c", "a"]
    # unseen value gets unknownIndex
    out2 = model.transform(Table({"c": np.array(["z"], object)}))
    assert out2["ci"][0] == -1


def test_count_selector_drops_zero_slots():
    X = np.zeros((10, 4), np.float32)
    X[:, 1] = 1.0
    X[::2, 3] = 2.0
    df = Table({"features": X})
    out = tfeat.CountSelector().fit(df).transform(df)
    assert out["features"].shape == (10, 2)


def test_data_conversion():
    df = Table({"x": np.array([1.7, 2.2]), "s": np.array([1, 2])})
    out = tfeat.DataConversion(cols=["x"], convertTo="integer").transform(df)
    assert out["x"].dtype == np.int32
    out2 = tfeat.DataConversion(cols=["s"], convertTo="string").transform(df)
    assert out2["s"].dtype == object and out2["s"][0] == "1"
    with pytest.raises(ValueError, match="unknown convertTo"):
        tfeat.DataConversion(cols=["x"], convertTo="complex").transform(df)


def test_text_featurizer_idf_pipeline():
    texts = np.array(["the cat sat", "the dog ran fast", "cat and dog play"],
                     object)
    df = Table({"text": texts})
    model = tfeat.TextFeaturizer(inputCol="text", numFeatures=64,
                                 useIDF=True).fit(df)
    X = model.transform(df)["features"]
    assert X.shape == (3, 64)
    assert (X != 0).any()


def test_multi_ngram_and_page_splitter():
    toks = np.empty(1, object)
    toks[0] = ["a", "b", "c"]
    out = tfeat.MultiNGram(inputCol="tokens", outputCol="grams",
                           lengths=[1, 2]).transform(Table({"tokens": toks}))
    assert out["grams"][0] == ["a", "b", "c", "a b", "b c"]

    text = np.array(["word " * 100], object)   # 500 chars
    pages = tfeat.PageSplitter(
        inputCol="t", maximumPageLength=120,
        minimumPageLength=80).transform(Table({"t": text}))["pages"][0]
    assert all(len(p) <= 120 for p in pages)
    assert "".join(pages) == text[0]


def test_compute_model_statistics_classification_and_regression():
    df = Table({"label": np.array([0, 0, 1, 1], np.float64),
                "prediction": np.array([0, 1, 1, 1], np.float64),
                "probability": np.array([[0.9, 0.1], [0.4, 0.6], [0.2, 0.8],
                                         [0.1, 0.9]])})
    stats = ttrain.ComputeModelStatistics(
        evaluationMetric="classification",
        scoresCol="probability").transform(df)
    assert stats["accuracy"][0] == pytest.approx(0.75)
    assert stats["AUC"][0] == pytest.approx(1.0)

    dfr = Table({"label": np.array([1.0, 2.0, 3.0]),
                 "prediction": np.array([1.1, 2.1, 2.9])})
    statsr = ttrain.ComputeModelStatistics(
        evaluationMetric="regression").transform(dfr)
    assert statsr["rmse"][0] == pytest.approx(0.1, abs=1e-6)
    assert statsr["R^2"][0] > 0.95


def test_per_instance_statistics():
    df = Table({"label": np.array([0.0, 1.0]),
                "prediction": np.array([0.0, 1.0]),
                "probability": np.array([[0.8, 0.2], [0.3, 0.7]])})
    out = ttrain.ComputePerInstanceStatistics().transform(df)
    np.testing.assert_allclose(out["log_loss"], [-np.log(0.8), -np.log(0.7)],
                               rtol=1e-6)


def test_train_classifier_end_to_end(binary_data):
    Xtr, Xte, ytr, yte = binary_data
    df = Table({f"f{j}": Xtr[:, j] for j in range(6)})
    df["label"] = np.where(ytr > 0, "pos", "neg").astype(object)
    est = ttrain.TrainClassifier(
        model=LightGBMClassifier(numIterations=20, device=CPU),
        labelCol="label")
    model = est.fit(df)
    te = Table({f"f{j}": Xte[:, j] for j in range(6)})
    out = model.transform(te)
    assert "scored_labels" in out
    acc = (out["scored_labels"] == np.where(yte > 0, "pos", "neg")).mean()
    assert acc > 0.85


def test_train_regressor_end_to_end(regression_data):
    from synapseml_tpu_torch.train.metrics import regression_metrics

    Xtr, Xte, ytr, yte = regression_data
    df = Table({f"f{j}": Xtr[:, j] for j in range(Xtr.shape[1])})
    df["label"] = ytr
    model = ttrain.TrainRegressor(
        model=LightGBMRegressor(numIterations=30, device=CPU)).fit(df)
    te = Table({f"f{j}": Xte[:, j] for j in range(Xte.shape[1])})
    pred = model.transform(te)["prediction"]
    m = regression_metrics(yte, pred)
    assert m["R^2"] > 0.2


def test_ranking_ndcg_metric():
    y = np.array([3, 2, 1, 0, 3, 0])
    g = np.array([0, 0, 0, 0, 1, 1])
    perfect = ttrain.ranking_ndcg(y, y.astype(float), g)
    assert perfect == pytest.approx(1.0)
    worst = ttrain.ranking_ndcg(y, -y.astype(float), g)
    assert worst < 1.0


# ---------------------------------------------------------------------------
# parity with the JAX package on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(numFeatures=4),
                                dict(oneHotEncodeCategoricals=False),
                                dict(imputeMissing=False)])
def test_featurize_is_bitwise_the_jax_packages(kw):
    cols = _adult_like(300, seed=2)
    cols.pop("income")
    cols["vec"] = np.random.default_rng(3).normal(size=(300, 3)).astype(
        np.float32)
    cols["flag"] = np.arange(300) % 3 == 0
    tm = tfeat.Featurize(**kw).fit(Table(cols))
    jm = jfeat.Featurize(**kw).fit(JTable(cols))
    assert tm.plans == jm.plans and tm.feature_dim == jm.feature_dim
    _bitwise(tm.transform(Table(cols))["features"],
             jm.transform(JTable(cols))["features"])


def test_clean_indexer_selector_conversion_are_bitwise_the_jax_packages():
    cols = _adult_like(200, seed=4)
    num = {"age": cols["age"], "hours": cols["hours-per-week"]}
    for mode, extra in (("Mean", {}), ("Median", {}),
                        ("Custom", {"customValue": -3.5})):
        t = tfeat.CleanMissingData(cleaningMode=mode, **extra).fit(Table(num))
        j = jfeat.CleanMissingData(cleaningMode=mode, **extra).fit(
            JTable(num))
        assert t.fillValues == j.fillValues
        for c in num:
            _bitwise(t.transform(Table(num))[c], j.transform(JTable(num))[c])
    for col in ("workclass", "age"):
        d = {col: cols[col]}
        t = tfeat.ValueIndexer(inputCol=col, outputCol="i").fit(Table(d))
        j = jfeat.ValueIndexer(inputCol=col, outputCol="i").fit(JTable(d))
        assert t.levels == j.levels
        ti, ji = t.transform(Table(d)), j.transform(JTable(d))
        _bitwise(ti["i"], ji["i"])
        back = {"i": np.append(ti["i"], [-1, 10_000])}
        _bitwise(tfeat.IndexToValue(inputCol="i", outputCol="v",
                                    levels=t.levels).transform(
                     Table(back))["v"],
                 jfeat.IndexToValue(inputCol="i", outputCol="v",
                                    levels=j.levels).transform(
                     JTable(back))["v"])
    X = np.random.default_rng(5).normal(size=(50, 8)).astype(np.float32)
    X[:, [1, 4]] = 0.0
    t = tfeat.CountSelector().fit(Table({"features": X}))
    j = jfeat.CountSelector().fit(JTable({"features": X}))
    assert t.indices == j.indices
    _bitwise(t.transform(Table({"features": X}))["features"],
             j.transform(JTable({"features": X}))["features"])
    conv = {"x": np.array([1.7, -2.2, 0.0]), "n": np.array([1, 0, 3]),
            "d": np.array(["2024-01-02 03:04:05", "2021-03-07 10:11:12",
                           "2020-02-29T00:00:00"], object),
            "e": np.array(["3/7/2021 10:11:12", "12/31/1999 23:59:59",
                           "2020-02-29T00:00:00"], object)}
    for cols_, to, fmt in ((["x", "n"], "boolean", None),
                           (["x"], "byte", None), (["x"], "long", None),
                           (["n"], "float", None), (["x", "n"], "string", None),
                           (["d"], "date", None),
                           (["e"], "date", "M/d/yyyy HH:mm:ss")):
        kw = dict(cols=cols_, convertTo=to)
        if fmt:
            kw["dateTimeFormat"] = fmt
        t = tfeat.DataConversion(**kw).transform(Table(conv))
        j = jfeat.DataConversion(**kw).transform(JTable(conv))
        for c in conv:
            _bitwise(t[c], j[c])


@pytest.mark.parametrize("kw", [
    dict(numFeatures=256),                                   # native path
    dict(numFeatures=256, binary=True, minTokenLength=2),
    dict(numFeatures=100, useIDF=False),                     # Python path
    dict(numFeatures=128, useStopWordsRemover=True, useNGram=True)])
def test_text_featurizer_is_bitwise_the_jax_packages(kw):
    rng = np.random.default_rng(6)
    vocab = ["the", "cat", "Dog", "ran", "a", "fast", "mat", "on", "x_y",
             "HTML", "sat", "42"]
    docs = np.array([" ".join(rng.choice(vocab, size=int(k)))
                     for k in rng.integers(0, 80, size=80)], object)
    t = tfeat.TextFeaturizer(inputCol="text", **kw).fit(Table({"text": docs}))
    j = jfeat.TextFeaturizer(inputCol="text", **kw).fit(
        JTable({"text": docs}))
    _bitwise(t.idf_, j.idf_)
    _bitwise(t.transform(Table({"text": docs}))["features"],
             j.transform(JTable({"text": docs}))["features"])


def test_multi_ngram_and_page_splitter_are_the_jax_packages():
    rng = np.random.default_rng(7)
    toks = np.empty(20, object)
    for i in range(20):
        toks[i] = [str(w) for w in rng.choice(list("abcde"),
                                              size=int(rng.integers(0, 6)))]
    kw = dict(inputCol="tokens", outputCol="g", lengths=[1, 2, 4])
    assert list(tfeat.MultiNGram(**kw).transform(Table({"tokens": toks}))["g"]) \
        == list(jfeat.MultiNGram(**kw).transform(JTable({"tokens": toks}))["g"])
    text = np.array(["lorem ipsum dolor " * int(k)
                     for k in rng.integers(1, 60, size=10)], object)
    kw = dict(inputCol="t", maximumPageLength=90, minimumPageLength=50)
    assert list(tfeat.PageSplitter(**kw).transform(Table({"t": text}))["pages"]) \
        == list(jfeat.PageSplitter(**kw).transform(
            JTable({"t": text}))["pages"])


def test_metrics_are_bitwise_the_jax_packages():
    from synapseml_tpu.train import metrics as jm
    from synapseml_tpu_torch.train import metrics as tm

    rng = np.random.default_rng(8)
    y = (rng.random(500) > 0.6).astype(np.float64)
    s = np.round(rng.random(500), 2)               # ties on purpose
    p = (s > 0.5).astype(np.float64)
    assert tm.auc_score(y, s) == jm.auc_score(y, s)
    a, b = (tm.binary_classification_metrics(y, p, s),
            jm.binary_classification_metrics(y, p, s))
    assert a.keys() == b.keys()
    for k in a:
        _bitwise(np.float64(a[k]) if np.isscalar(a[k]) else a[k],
                 np.float64(b[k]) if np.isscalar(b[k]) else b[k])
    yk, pk = rng.integers(0, 4, 300), rng.integers(0, 4, 300)
    a, b = tm.multiclass_metrics(yk, pk), jm.multiclass_metrics(yk, pk)
    for k in a:
        _bitwise(np.float64(a[k]) if np.isscalar(a[k]) else a[k],
                 np.float64(b[k]) if np.isscalar(b[k]) else b[k])
    yr, pr = rng.normal(size=300), rng.normal(size=300)
    a, b = tm.regression_metrics(yr, pr), jm.regression_metrics(yr, pr)
    assert {k: np.float64(v).tobytes() for k, v in a.items()} \
        == {k: np.float64(v).tobytes() for k, v in b.items()}
    g = rng.integers(0, 20, 300)
    for k in (None, 3):
        assert tm.ranking_ndcg(yk, pr, g, k) == jm.ranking_ndcg(yk, pr, g, k)


def test_statistics_are_bitwise_the_jax_packages():
    rng = np.random.default_rng(9)
    y = (rng.random(200) > 0.5).astype(np.float64)
    prob = rng.random((200, 1))
    prob = np.concatenate([1 - prob, prob], 1)
    cols = {"label": y, "prediction": (prob[:, 1] > 0.5).astype(np.float64),
            "probability": prob}
    for metric in ("classification", "all", "regression"):
        t = ttrain.ComputeModelStatistics(evaluationMetric=metric,
                                          scoresCol="probability"
                                          ).transform(Table(cols))
        j = jtrain.ComputeModelStatistics(evaluationMetric=metric,
                                          scoresCol="probability"
                                          ).transform(JTable(cols))
        assert t.columns == j.columns
        for c in t.columns:
            _bitwise(t[c], j[c])
        t = ttrain.ComputePerInstanceStatistics(
            evaluationMetric=metric).transform(Table(cols))
        j = jtrain.ComputePerInstanceStatistics(
            evaluationMetric=metric).transform(JTable(cols))
        for c in t.columns:
            _bitwise(t[c], j[c])


@pytest.fixture(scope="module")
def adult_pair():
    """TrainClassifier fitted by both packages on the same Adult-shaped
    table (the port on the CPU)."""
    cols = _adult_like(600, seed=10)
    kw = dict(numIterations=8, numLeaves=7, minDataInLeaf=5)
    tm = ttrain.TrainClassifier(model=LightGBMClassifier(device=CPU, **kw),
                                labelCol="income").fit(Table(cols))
    jm = jtrain.TrainClassifier(model=JLGBMClassifier(**kw),
                                labelCol="income").fit(JTable(cols))
    return cols, tm, jm


def test_train_classifier_grows_the_jax_packages_trees(adult_pair):
    cols, tm, jm = adult_pair
    assert tm.indexer.levels == jm.indexer.levels == ["<=50K", ">50K"]
    assert tm.featurizer.plans == jm.featurizer.plans
    _same_trees(tm.innerModel.booster, jm.innerModel.booster)
    assert tm.innerModel.booster.model_string() \
        == jm.innerModel.booster.model_string()
    test = {k: v for k, v in _adult_like(200, seed=11).items()
            if k != "income"}
    to, jo = tm.transform(Table(test)), jm.transform(JTable(test))
    _bitwise(to["features"], jo["features"])
    np.testing.assert_allclose(to["probability"], jo["probability"],
                               rtol=0, atol=LOAD_TOL)
    assert list(to["scored_labels"]) == list(jo["scored_labels"])


def test_train_regressor_grows_the_jax_packages_trees():
    cols = _adult_like(500, seed=12)
    cols["income"] = cols["age"] * 0.1 + (cols["sex"] == "Male") * 2.0
    kw = dict(numIterations=8, numLeaves=7, minDataInLeaf=5)
    tm = ttrain.TrainRegressor(model=LightGBMRegressor(device=CPU, **kw),
                               labelCol="income").fit(Table(cols))
    jm = jtrain.TrainRegressor(model=JLGBMRegressor(**kw),
                               labelCol="income").fit(JTable(cols))
    _same_trees(tm.innerModel.booster, jm.innerModel.booster,
                leaf_tol=REGRESSOR_LEAF_TOL)
    np.testing.assert_allclose(tm.transform(Table(cols))["prediction"],
                               jm.transform(JTable(cols))["prediction"],
                               rtol=0, atol=8 * REGRESSOR_LEAF_TOL)


def test_train_classifier_keeps_the_callers_estimator_and_device():
    cols = _adult_like(200, seed=13)
    est = LightGBMClassifier(numIterations=3, device=CPU)
    m = ttrain.TrainClassifier(model=est, labelCol="income").fit(Table(cols))
    assert est.labelCol == "label"               # the caller's is untouched
    assert m.innerModel.get("device") == CPU
    default = ttrain.TrainClassifier(labelCol="income")
    assert default.model is None    # the port's LightGBMClassifier, on cuda


def test_a_fit_in_a_thread_equals_the_fit_alone():
    cols = _adult_like(400, seed=14)

    def fit():
        return ttrain.TrainClassifier(
            model=LightGBMClassifier(numIterations=4, numLeaves=7,
                                     device=CPU),
            labelCol="income").fit(Table(cols))

    alone = fit().innerModel.booster.model_string()
    got = [None] * 3

    def run(i):
        got[i] = fit().innerModel.booster.model_string()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    join_threads(threads, what="concurrent TrainClassifier fits")
    assert got == [alone] * 3


def test_jax_saved_models_load_and_score_the_same(adult_pair, tmp_path):
    cols, _, jm = adult_pair
    test = {k: v for k, v in _adult_like(150, seed=15).items()
            if k != "income"}
    want = jm.transform(JTable(test))
    jm.save(str(tmp_path / "trained"))
    loaded = PipelineStage.load(str(tmp_path / "trained"), device=CPU)
    assert type(loaded) is ttrain.TrainedClassifierModel
    assert type(loaded.featurizer) is tfeat.FeaturizeModel
    assert type(loaded.indexer) is tfeat.ValueIndexerModel
    got = loaded.transform(Table(test))
    _bitwise(got["features"], want["features"])
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=LOAD_TOL)
    assert list(got["scored_labels"]) == list(want["scored_labels"])
    # the fitted featurizer and indexer alone: their plans and levels are
    # their whole state
    jm.featurizer.save(str(tmp_path / "feat"))
    jm.indexer.save(str(tmp_path / "idx"))
    feat = PipelineStage.load(str(tmp_path / "feat"))
    idx = PipelineStage.load(str(tmp_path / "idx"))
    assert feat.plans == jm.featurizer.plans
    _bitwise(feat.transform(Table(test))["features"], want["features"])
    assert idx.levels == jm.indexer.levels
    # and the port's own save of the same model loads back equal
    loaded.save(str(tmp_path / "again"))
    again = PipelineStage.load(str(tmp_path / "again"), device=CPU)
    np.testing.assert_array_equal(again.transform(Table(test))["probability"],
                                  got["probability"])
