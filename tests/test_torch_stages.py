"""The port's pipeline stages and balance measures (``synapseml_tpu_torch/
stages``, ``exploratory``) against the JAX package's, on the CPU:

* every scenario of ``tests/test_stages.py`` and ``tests/test_exploratory.py``
  on the port;
* the same seeded numpy inputs through both packages: every stage's output
  and the three balance measures bitwise (host numpy in both; float64 where
  the measures compute);
* stages saved by the JAX package load in the port with their state.
"""

import logging

import numpy as np
import pytest

from synapseml_tpu import exploratory as jexp
from synapseml_tpu import stages as jstages
from synapseml_tpu.core.table import Table as JTable

from synapseml_tpu_torch.core import Table
from synapseml_tpu_torch.core.pipeline import Pipeline, PipelineStage
from synapseml_tpu_torch.exploratory import (AggregateBalanceMeasure,
                                             DistributionBalanceMeasure,
                                             FeatureBalanceMeasure)
from synapseml_tpu_torch.stages import (
    Cacher,
    ClassBalancer,
    DropColumns,
    DynamicMiniBatchTransformer,
    EnsembleByKey,
    Explode,
    FixedMiniBatchTransformer,
    FlattenBatch,
    Lambda,
    MultiColumnAdapter,
    PartitionConsolidator,
    RenameColumn,
    Repartition,
    SelectColumns,
    StratifiedRepartition,
    SummarizeData,
    TextPreprocessor,
    TimeIntervalMiniBatchTransformer,
    Timer,
    UDFTransformer,
    UnicodeNormalize,
)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)


@pytest.fixture
def df():
    return Table({
        "x": np.arange(10, dtype=np.float32),
        "y": np.arange(10) % 3,
        "s": np.asarray([f"w{i}" for i in range(10)], dtype=object),
    })


def _same(got, want):
    """Two tables (or arrays) with the same columns, dtypes and bytes."""
    if isinstance(got, np.ndarray) or np.isscalar(got):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.dtype == object:
            assert len(got) == len(want)
            for a, b in zip(got.ravel(), want.ravel()):
                if isinstance(a, np.ndarray):
                    _same(a, b)
                else:
                    assert (a == b) or (a != a and b != b), (a, b)
        else:
            assert np.ascontiguousarray(got).tobytes() \
                == np.ascontiguousarray(want).tobytes()
        return
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        _same(got[c], want[c])


# ---------------------------------------------------------------------------
# the JAX package's stage scenarios, on the port
# ---------------------------------------------------------------------------

def test_fixed_minibatch_roundtrip(df):
    batched = FixedMiniBatchTransformer(batchSize=3).transform(df)
    assert batched.num_rows == 4  # 3+3+3+1
    assert len(batched["x"][0]) == 3 and len(batched["x"][3]) == 1
    flat = FlattenBatch().transform(batched)
    np.testing.assert_array_equal(flat["x"], df["x"])
    np.testing.assert_array_equal(flat["s"], df["s"])


def test_fixed_minibatch_padding(df):
    batched = FixedMiniBatchTransformer(batchSize=4,
                                        padBatches=True).transform(df)
    assert all(len(b) == 4 for b in batched["x"])
    flat = FlattenBatch().transform(batched)
    assert flat.num_rows == 10
    np.testing.assert_array_equal(flat["x"], df["x"])


def test_dynamic_and_time_interval_batchers(df):
    b1 = DynamicMiniBatchTransformer().transform(df)
    assert b1.num_rows == 1 and len(b1["x"][0]) == 10
    b2 = TimeIntervalMiniBatchTransformer(maxBatchSize=6).transform(df)
    assert [len(b) for b in b2["x"]] == [6, 4]


def test_udf_transformer_vectorized(df):
    t = UDFTransformer(inputCol="x", outputCol="x2").setUDF(lambda x: x * 2)
    out = t.transform(df)
    np.testing.assert_allclose(out["x2"], df["x"] * 2)


def test_udf_transformer_multi_input_rowwise(df):
    t = (UDFTransformer(vectorized=False, outputCol="z")
         .setInputCols(["x", "y"]).setUDF(lambda x, y: float(x) + float(y)))
    out = t.transform(df)
    np.testing.assert_allclose(out["z"], df["x"] + df["y"])


def test_lambda_and_cacher(df):
    lam = Lambda().setTransform(lambda t: t.with_column("c", t["x"] + 1))
    out = Cacher().transform(lam.transform(df))
    np.testing.assert_allclose(out["c"], df["x"] + 1)


def test_timer_wraps_transformer(df, caplog):
    t = Timer().setStage(UDFTransformer(inputCol="x",
                                        outputCol="o").setUDF(lambda x: x))
    with caplog.at_level(logging.INFO, logger="synapseml_tpu_torch"):
        out = t.transform(df)
    assert "o" in out and t.elapsed_transform_s >= 0
    # the port's logger, never the JAX package's
    assert any(r.name == "synapseml_tpu_torch" and "Timer[" in r.getMessage()
               for r in caplog.records)


def test_column_plumbing(df):
    assert SelectColumns(cols=["x"]).transform(df).columns == ["x"]
    assert "y" not in DropColumns(cols=["y"]).transform(df)
    out = RenameColumn(inputCol="x", outputCol="xx").transform(df)
    assert "xx" in out and "x" not in out


def test_explode():
    df = Table({"k": np.asarray([1, 2]),
                "v": np.asarray([np.asarray([1, 2, 3]), np.asarray([4])],
                                dtype=object)})
    out = Explode(inputCol="v").transform(df)
    np.testing.assert_array_equal(out["k"], [1, 1, 1, 2])
    np.testing.assert_array_equal(out["v"], [1, 2, 3, 4])


def test_class_balancer(df):
    model = ClassBalancer(inputCol="y").fit(df)
    out = model.transform(df)
    # class 0 occurs 4x, classes 1/2 occur 3x → weights 1.0 and 4/3
    w = out["weight"]
    np.testing.assert_allclose(w[df["y"] == 0], 1.0)
    np.testing.assert_allclose(w[df["y"] == 1], 4 / 3)


def test_stratified_repartition():
    labels = np.asarray([0] * 8 + [1] * 2)
    df = Table({"label": labels, "i": np.arange(10)})
    out = StratifiedRepartition(mode="original").transform(df)
    assert out.num_rows == 10
    # each half (shard) should contain at least one of the minority class
    halves = [out["label"][:5], out["label"][5:]]
    assert all((h == 1).any() for h in halves)
    eq = StratifiedRepartition(mode="equal").transform(df)
    vals, counts = np.unique(eq["label"], return_counts=True)
    assert counts[0] == counts[1]


def test_ensemble_by_key():
    df = Table({"k": np.asarray(["a", "a", "b"]),
                "score": np.asarray([1.0, 3.0, 5.0])})
    out = EnsembleByKey().setKeys(["k"]).setCols(["score"]).transform(df)
    m = dict(zip(out["k"], out["mean(score)"]))
    assert m["a"] == 2.0 and m["b"] == 5.0
    joined = (EnsembleByKey(collapseGroup=False)
              .setKeys(["k"]).setCols(["score"]).transform(df))
    assert joined.num_rows == 3
    np.testing.assert_allclose(joined["mean(score)"], [2.0, 2.0, 5.0])


def test_partition_consolidator(df):
    out = PartitionConsolidator(numPartitions=2, concurrency=3).transform(df)
    assert out.num_shards_hint == 2 and out.concurrency_hint == 3


def test_repartition(df):
    out = Repartition(n=4).transform(df)
    assert out.num_shards_hint == 4
    shards = out.shard(4)
    assert len(shards) == 4


def test_text_preprocessor():
    df = Table({"text": np.asarray(["The happy sad"], dtype=object)})
    t = (TextPreprocessor(inputCol="text", outputCol="out",
                          normFunc="lowercase")
         .setMap({"happy": "sad", "the": "a"}))
    assert t.transform(df)["out"][0] == "a sad sad"


def test_unicode_normalize():
    df = Table({"text": np.asarray(["Ça Va"], dtype=object)})
    out = UnicodeNormalize(inputCol="text", outputCol="n",
                           form="NFKD").transform(df)
    assert out["n"][0] == "ça va".encode().decode() or "c" in out["n"][0]


def test_summarize_data(df):
    out = SummarizeData().transform(df)
    feats = list(out["Feature"])
    assert "x" in feats
    row = out.filter(out["Feature"] == "x")
    assert row["Count"][0] == 10
    np.testing.assert_allclose(row["Mean"][0], 4.5)
    np.testing.assert_allclose(row["Quantile 50%"][0], 4.5)


def test_multi_column_adapter(df):
    base = UDFTransformer().setUDF(lambda x: x)  # identity unary stage
    adapter = (MultiColumnAdapter()
               .setInputCols(["x", "y"]).setOutputCols(["x2", "y2"])
               .setBaseStage(base))
    out = adapter.fit(df).transform(df)
    np.testing.assert_array_equal(out["x2"], df["x"])
    np.testing.assert_array_equal(out["y2"], df["y"])


def test_stage_save_load_roundtrip(tmp_path, df):
    t = FixedMiniBatchTransformer(batchSize=7)
    t.save(str(tmp_path / "s"))
    loaded = PipelineStage.load(str(tmp_path / "s"))
    assert isinstance(loaded, FixedMiniBatchTransformer)
    assert loaded.getBatchSize() == 7


def test_complex_param_save_load(tmp_path, df):
    """Complex params (callables, nested stages) survive save/load."""
    pipe = Pipeline([
        UDFTransformer(inputCol="x", outputCol="x2").setUDF(lambda x: x * 3),
        Lambda().setTransform(lambda t: t.with_column("c", t["x2"] + 1)),
    ])
    model = pipe.fit(df)
    expected = model.transform(df)
    model.save(str(tmp_path / "p"))
    loaded = PipelineStage.load(str(tmp_path / "p"))
    out = loaded.transform(df)
    np.testing.assert_allclose(out["x2"], expected["x2"])
    np.testing.assert_allclose(out["c"], expected["c"])

    # nested-stage complex param (Timer wraps a stage)
    timer = Timer().setStage(UDFTransformer(inputCol="x",
                                            outputCol="o").setUDF(lambda x: x))
    timer.save(str(tmp_path / "t"))
    lt = PipelineStage.load(str(tmp_path / "t"))
    assert "o" in lt.transform(df)


# ---------------------------------------------------------------------------
# the JAX package's balance-measure scenarios, on the port
# ---------------------------------------------------------------------------

def _cohort():
    # gender: 6 M (4 positive), 4 F (1 positive) — a visible parity gap
    gender = np.array(["M"] * 6 + ["F"] * 4, object)
    label = np.array([1, 1, 1, 1, 0, 0, 1, 0, 0, 0], np.float64)
    return Table({"gender": gender, "label": label})


class TestFeatureBalance:
    def test_dp_gap(self):
        out = FeatureBalanceMeasure(sensitiveCols=["gender"],
                                    labelCol="label").transform(_cohort())
        assert out.num_rows == 1
        row = {c: out[c][0] for c in out.columns}
        assert {"FeatureName", "ClassA", "ClassB", "dp"} <= set(out.columns)
        got = abs(row["dp"])
        assert got == pytest.approx(abs(4 / 6 - 1 / 4), abs=1e-9)

    def test_balanced_feature_has_zero_gaps(self):
        df = Table({"g": np.array(["A", "A", "B", "B"], object),
                    "label": np.array([1.0, 0.0, 1.0, 0.0])})
        out = FeatureBalanceMeasure(sensitiveCols=["g"],
                                    labelCol="label").transform(df)
        assert abs(out["dp"][0]) < 1e-9
        assert abs(out["ji"][0]) < 1e-9


class TestDistributionBalance:
    def test_uniform_reference(self):
        df = Table({"g": np.array(["A"] * 8 + ["B"] * 2, object)})
        out = DistributionBalanceMeasure(sensitiveCols=["g"]).transform(df)
        row = {c: out[c][0] for c in out.columns}
        # observed [.8, .2] vs uniform [.5, .5]
        assert row["total_variation_dist"] == pytest.approx(0.3)
        assert row["inf_norm_dist"] == pytest.approx(0.3)
        assert row["kl_divergence"] > 0
        assert 0 <= row["chi_sq_p_value"] <= 1

    def test_perfectly_uniform_is_zero(self):
        df = Table({"g": np.array(["A", "B", "C", "A", "B", "C"], object)})
        out = DistributionBalanceMeasure(sensitiveCols=["g"]).transform(df)
        assert out["kl_divergence"][0] == pytest.approx(0.0, abs=1e-9)
        assert out["js_dist"][0] == pytest.approx(0.0, abs=1e-6)

    def test_custom_reference(self):
        df = Table({"g": np.array(["A"] * 8 + ["B"] * 2, object)})
        out = DistributionBalanceMeasure(
            sensitiveCols=["g"],
            referenceDistribution=[{"A": 0.8, "B": 0.2}]).transform(df)
        assert out["kl_divergence"][0] == pytest.approx(0.0, abs=1e-9)

    def test_chi2_sf_sanity(self):
        from synapseml_tpu_torch.exploratory.balance import _chi2_sf

        # chi2 sf(3.84, 1) ~ 0.05; sf(0, k) = 1
        assert _chi2_sf(3.841, 1) == pytest.approx(0.05, abs=0.002)
        assert _chi2_sf(0.0, 3) == 1.0


class TestAggregateBalance:
    def test_uniform_is_perfectly_equal(self):
        df = Table({"g": np.array(["A", "B", "C", "D"] * 5, object)})
        out = AggregateBalanceMeasure(sensitiveCols=["g"]).transform(df)
        assert out["atkinson_index"][0] == pytest.approx(0.0, abs=1e-9)
        assert out["theil_t_index"][0] == pytest.approx(0.0, abs=1e-9)
        assert out["theil_l_index"][0] == pytest.approx(0.0, abs=1e-9)

    def test_skewed_is_unequal(self):
        df = Table({"g": np.array(["A"] * 19 + ["B"], object)})
        out = AggregateBalanceMeasure(sensitiveCols=["g"]).transform(df)
        assert out["atkinson_index"][0] > 0.1
        assert out["theil_t_index"][0] > 0.1


# ---------------------------------------------------------------------------
# parity with the JAX package on the same inputs
# ---------------------------------------------------------------------------

def _columns(n=97, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    return {"x": x, "k": rng.integers(0, 5, n),
            "v": rng.normal(size=(n, 3)).astype(np.float32),
            "s": np.array([rng.choice(["Ça va", "déjà vu", "the happy cat",
                                       "", "HTML"]) for _ in range(n)],
                          object),
            "label": (rng.random(n) > 0.7).astype(np.float64)}


# (stage factory, applied to both packages' module) — every stage whose
# output depends on its inputs alone
STAGE_CASES = {
    "fixed": lambda m: m.FixedMiniBatchTransformer(batchSize=10),
    "fixed_pad": lambda m: m.FixedMiniBatchTransformer(batchSize=10,
                                                       padBatches=True),
    "dynamic": lambda m: m.DynamicMiniBatchTransformer(maxBatchSize=40),
    "interval": lambda m: m.TimeIntervalMiniBatchTransformer(maxBatchSize=33),
    "udf": lambda m: m.UDFTransformer(inputCol="x", outputCol="o").setUDF(
        lambda x: np.nan_to_num(x) * 3),
    "select": lambda m: m.SelectColumns(cols=["k", "x"]),
    "drop": lambda m: m.DropColumns(cols=["v"]),
    "rename": lambda m: m.RenameColumn(inputCol="k", outputCol="kk"),
    "repartition": lambda m: m.Repartition(n=3),
    "stratified_original": lambda m: m.StratifiedRepartition(
        labelCol="k", mode="original", seed=3),
    "stratified_equal": lambda m: m.StratifiedRepartition(
        labelCol="k", mode="equal", seed=3),
    "stratified_mixed": lambda m: m.StratifiedRepartition(labelCol="label"),
    "ensemble": lambda m: m.EnsembleByKey(keys=["k"], cols=["x", "v"]),
    "ensemble_joined": lambda m: m.EnsembleByKey(
        keys=["k", "label"], cols=["v"], collapseGroup=False),
    "preprocess": lambda m: m.TextPreprocessor(
        inputCol="s", outputCol="o", normFunc="lowercase").setMap(
        {"happy": "sad", "the": "a", "ht": "X"}),
    "unicode": lambda m: m.UnicodeNormalize(inputCol="s", outputCol="o",
                                            form="NFKD"),
    "summarize": lambda m: m.SummarizeData(),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_stages_are_bitwise_the_jax_packages(case):
    cols = _columns()
    if case == "summarize":
        cols.pop("v")
    got = STAGE_CASES[case](__import__(
        "synapseml_tpu_torch.stages", fromlist=["x"])).transform(Table(cols))
    want = STAGE_CASES[case](jstages).transform(JTable(cols))
    _same(got, want)
    if case.startswith("fixed"):
        _same(FlattenBatch().transform(got),
              jstages.FlattenBatch().transform(want))


def test_class_balancer_and_explode_are_the_jax_packages(tmp_path):
    cols = _columns(seed=1)
    t = ClassBalancer(inputCol="k").fit(Table(cols))
    j = jstages.ClassBalancer(inputCol="k").fit(JTable(cols))
    _same(t.transform(Table(cols)), j.transform(JTable(cols)))
    # a balancer the JAX package saved loads in the port with its weights
    j.save(str(tmp_path / "bal"))
    loaded = PipelineStage.load(str(tmp_path / "bal"))
    assert type(loaded) is type(t)
    _same(loaded.transform(Table(cols)), j.transform(JTable(cols)))
    lists = np.empty(5, object)
    for i in range(5):
        lists[i] = np.arange(i, dtype=np.int64)
    ex = {"k": np.arange(5), "v": lists}
    _same(Explode(inputCol="v", outputCol="e").transform(Table(ex)),
          jstages.Explode(inputCol="v", outputCol="e").transform(JTable(ex)))


@pytest.mark.parametrize("verbose", [False, True])
def test_balance_measures_are_bitwise_the_jax_packages(verbose):
    rng = np.random.default_rng(2)
    n = 500
    cols = {"race": rng.choice(["a", "b", "c", "d", "e"], size=n,
                               p=[0.6, 0.2, 0.1, 0.07, 0.03]).astype(object),
            "sex": rng.choice(["Male", "Female"], size=n).astype(object),
            "age": rng.integers(0, 4, n),
            "label": (rng.random(n) > 0.76).astype(np.float64)}
    sens = ["race", "sex", "age"]
    ref = [{"a": 0.5, "b": 0.2, "c": 0.1, "d": 0.1, "e": 0.1}, {}, None]
    for tcls, jcls, kw in (
            (FeatureBalanceMeasure, jexp.FeatureBalanceMeasure,
             dict(labelCol="label")),
            (DistributionBalanceMeasure, jexp.DistributionBalanceMeasure,
             dict(referenceDistribution=ref)),
            (DistributionBalanceMeasure, jexp.DistributionBalanceMeasure,
             {}),
            (AggregateBalanceMeasure, jexp.AggregateBalanceMeasure, {}),
            (AggregateBalanceMeasure, jexp.AggregateBalanceMeasure,
             dict(epsilon=0.5))):
        _same(tcls(sensitiveCols=sens, verbose=verbose, **kw).transform(
                  Table(cols)),
              jcls(sensitiveCols=sens, verbose=verbose, **kw).transform(
                  JTable(cols)))


def test_chi2_sf_is_the_jax_packages():
    from synapseml_tpu.exploratory.balance import _chi2_sf as jsf
    from synapseml_tpu.exploratory.balance import _krc as jkrc
    from synapseml_tpu_torch.exploratory.balance import _chi2_sf, _krc

    for x in (0.0, 0.5, 3.841, 10.0, 50.0, 400.0):
        for k in (1, 2, 5, 41):
            assert _chi2_sf(x, k) == jsf(x, k)
    for p in ((0.2, 0.3, 0.1), (0.5, 0.5, 0.0), (1.0, 0.24, 0.24)):
        assert _krc(*p) == jkrc(*p)
