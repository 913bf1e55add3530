"""The port's recommendation package (``synapseml_tpu_torch/recommendation``)
against the JAX package's, on the CPU:

* every scenario of ``tests/test_recommendation.py`` on the port;
* SAR's ``itemSimilarity`` and ``userAffinity`` bit for bit the JAX
  package's for all three similarity functions, without a time column, with
  numeric and string times and with ``startTime`` (0/1 co-occurrence counts
  are exact integers in float32, jaccard and lift single IEEE divisions;
  the affinity is the same host numpy);
* ``ops.topk.top_k`` against ``jax.lax.top_k`` on rows with ties and on
  rows padded with −inf, and SAR's recommendations (every item a user's
  history never reaches scores 0: ties) equal to the JAX package's: the
  same item indices, scores within ``SCORE_RTOL`` (``affinity @
  similarity`` sums in another order); with time-decayed affinities two
  scores can lie within that roundoff of each other, and there the port
  may rank the pair the other way: its item's score by the JAX package's
  own scores must then be within ``SCORE_RTOL`` of the JAX item's;
* ``transform``'s predictions within ``SCORE_RTOL``, the indexer's and
  ranking evaluator's outputs equal, the adapter's and the
  train-validation split's choices the same;
* a model directory saved by the JAX package loads in the port with the
  same recommendations, and ``convert.sar_model_from_reference`` carries a
  model across with the same outputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synapseml_tpu import recommendation as jrec
from synapseml_tpu.core.table import Table as JTable

from synapseml_tpu_torch.convert import sar_model_from_reference
from synapseml_tpu_torch.core.pipeline import PipelineStage
from synapseml_tpu_torch.core.table import Table
from synapseml_tpu_torch.ops.topk import top_k
from synapseml_tpu_torch.recommendation import (RankingAdapter,
                                                RankingEvaluator,
                                                RankingTrainValidationSplit,
                                                RecommendationIndexer, SAR,
                                                SARModel)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
# float32 products of <= 40 terms in another order
SCORE_RTOL = 1e-6


def _ratings():
    # 3 users, 4 items; u0 and u1 overlap on items 0/1, u2 likes 2/3
    return Table({
        "user": np.array([0, 0, 0, 1, 1, 2, 2, 1], dtype=np.int64),
        "item": np.array([0, 1, 2, 0, 1, 2, 3, 3], dtype=np.int64),
        "rating": np.ones(8, dtype=np.float32),
    })


class TestIndexer:
    def test_roundtrip(self):
        df = Table({"user": np.array(["alice", "bob", "alice"]),
                    "item": np.array(["x", "y", "y"]),
                    "rating": np.ones(3)})
        model = RecommendationIndexer(userInputCol="user", itemInputCol="item",
                                      userOutputCol="u", itemOutputCol="i").fit(df)
        out = model.transform(df)
        assert out["u"].tolist() == [0, 1, 0]
        assert out["i"].tolist() == [0, 1, 1]
        assert model.recover_users([0, 1]) == ["alice", "bob"]
        assert model.num_items == 2


class TestSAR:
    def test_jaccard_similarity_values(self):
        model = SAR(supportThreshold=1, similarityFunction="jaccard",
                    device=CPU).fit(_ratings())
        sim = model.get("itemSimilarity")
        assert sim[0, 1] == pytest.approx(2 / (2 + 2 - 2))
        assert sim[0, 3] == pytest.approx(1 / 3)

    def test_cooccurrence_and_lift(self):
        cooc = SAR(supportThreshold=1, similarityFunction="cooccurrence",
                   device=CPU).fit(_ratings()).get("itemSimilarity")
        assert cooc[0, 0] == 2 and cooc[0, 1] == 2
        lift = SAR(supportThreshold=1, similarityFunction="lift",
                   device=CPU).fit(_ratings()).get("itemSimilarity")
        assert lift[0, 1] == pytest.approx(2 / (2 * 2))

    def test_support_threshold_drops_items(self):
        sim = SAR(supportThreshold=3, similarityFunction="cooccurrence",
                  device=CPU).fit(_ratings()).get("itemSimilarity")
        assert (sim == 0).all()

    def test_recommend_and_transform(self):
        df = _ratings()
        model = SAR(supportThreshold=1, device=CPU).fit(df)
        recs = model.recommend_for_all_users(2)
        assert recs["recommendations"].shape == (3, 2)
        scored = model.transform(df)
        assert "prediction" in scored and np.isfinite(scored["prediction"]).all()

    def test_time_decay(self):
        df = Table({
            "user": np.array([0, 0], dtype=np.int64),
            "item": np.array([0, 1], dtype=np.int64),
            "rating": np.ones(2, np.float32),
            "time": np.array(["2026-01-01 00:00:00", "2026-07-01 00:00:00"]),
        })
        model = SAR(supportThreshold=1, timeDecayCoeff=30, device=CPU).fit(df)
        aff = model.get("userAffinity")
        assert aff[0, 0] < aff[0, 1]
        assert aff[0, 1] == pytest.approx(1.0)  # reference time = max(t)

    def test_bad_similarity_rejected(self):
        with pytest.raises(ValueError, match="similarityFunction"):
            SAR(similarityFunction="cosine")

    def test_save_load(self, tmp_path):
        model = SAR(supportThreshold=1, device=CPU).fit(_ratings())
        p = str(tmp_path / "sar")
        model.save(p)
        loaded = PipelineStage.load(p)
        np.testing.assert_allclose(loaded.get("itemSimilarity"),
                                   model.get("itemSimilarity"))


class TestRanking:
    def test_evaluator_perfect_and_zero(self):
        pred = np.empty(2, dtype=object)
        label = np.empty(2, dtype=object)
        pred[0], label[0] = [1, 2, 3], [1, 2, 3]
        pred[1], label[1] = [4, 5], [9, 8]
        m = RankingEvaluator(k=3).get_metrics(
            Table({"prediction": pred, "label": label}))
        assert m["ndcgAt"] == pytest.approx(0.5)  # one perfect, one zero
        assert 0 <= m["map"] <= 1 and 0 <= m["mrr"] <= 1

    def test_adapter_and_tvs(self):
        df = _ratings()
        adapter = RankingAdapter(recommender=SAR(supportThreshold=1,
                                                 device=CPU), k=2)
        out = adapter.fit(df).transform(df)
        assert set(out.columns) == {"user", "prediction", "label"}
        assert len(out["prediction"][0]) == 2

        tvs = RankingTrainValidationSplit(
            estimator=SAR(supportThreshold=1, device=CPU),
            evaluator=RankingEvaluator(k=2, metricName="recallAtK"),
            estimatorParamMaps=[{"similarityFunction": "jaccard"},
                                {"similarityFunction": "lift"}],
            trainRatio=0.6)
        model = tvs.fit(df)
        assert len(model.get("validationMetrics")) == 2
        assert model.get("bestParams")["similarityFunction"] in ("jaccard", "lift")


def test_the_card_is_the_default_device():
    assert SAR().getDevice() == "cuda"


# ---------------------------------------------------------------------------
# against the JAX package

def _log_columns(seed=0, users=40, items=30, n=400, times=None):
    """A seeded rating log: popular items drawn more often (ties in the
    co-occurrence counts), ratings 1-5 in halves."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, items + 1)
    cols = {"user": rng.integers(0, users, n).astype(np.int64),
            "item": rng.choice(items, n, p=pop / pop.sum()).astype(np.int64),
            "rating": (rng.integers(2, 11, n) / 2.0).astype(np.float32)}
    cols["user"][:users] = np.arange(users)         # every user present
    cols["item"][:items] = np.arange(items)         # every item present
    if times == "numeric":
        cols["time"] = rng.integers(1_600_000_000, 1_700_000_000, n
                                    ).astype(np.float64)
    elif times == "string":
        days = rng.integers(0, 365, n)
        cols["time"] = np.array([
            f"2025-{1 + d // 31 % 12:02d}-{1 + d % 28:02d} "
            f"{d % 24:02d}:{(7 * d) % 60:02d}:00" for d in days])
    return cols


FIT_CASES = [
    ("jaccard", None, {}),
    ("lift", None, dict(supportThreshold=2)),
    ("cooccurrence", None, dict(supportThreshold=5)),
    ("jaccard", "numeric", dict(timeDecayCoeff=10)),
    ("lift", "string", dict(timeDecayCoeff=30)),
    ("cooccurrence", "string", dict(startTime="2026-01-01 00:00:00")),
    ("jaccard", "string", dict(startTime="2026/02/01",
                               startTimeFormat="%Y/%m/%d")),
]


def _fit_both(kind, times, extra, seed=0):
    cols = _log_columns(seed, times=times)
    params = dict(similarityFunction=kind, **extra)
    jm = jrec.SAR(**params).fit(JTable(dict(cols)))
    tm = SAR(device=CPU, **params).fit(Table(dict(cols)))
    return jm, tm, cols


@pytest.mark.parametrize("kind,times,extra", FIT_CASES)
def test_similarity_and_affinity_are_bitwise_the_references(kind, times,
                                                            extra):
    jm, tm, _ = _fit_both(kind, times, extra)
    for name in ("itemSimilarity", "userAffinity"):
        a, b = jm.get(name), tm.get(name)
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes(), name


def _jax_top_k(s, k):
    v, i = jax.lax.top_k(jnp.asarray(s), k)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("masked", [False, True])
def test_top_k_is_jax_top_k(masked):
    rng = np.random.default_rng(7 + masked)
    s = rng.integers(-3, 4, size=(64, 97)).astype(np.float32)
    s[5] = 0.0                                 # one row all tied
    if masked:
        s[rng.random(s.shape) < 0.8] = -np.inf
        s[9] = -np.inf                         # nothing admissible
    for k in (1, 6, 40, 97):
        jv, ji = _jax_top_k(s, k)
        tv, ti = top_k(torch.from_numpy(s), k)
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(tv.numpy(), jv)
        assert ti.dtype == torch.int64


def test_top_k_ties_go_to_the_lower_index():
    s = np.zeros((1, 40), np.float32)
    s[0, [6, 18, 30]] = 1.0
    assert top_k(torch.from_numpy(s), 6)[1].tolist() == [[6, 18, 30, 0, 1, 2]]
    s = np.full((1, 12), -np.inf, np.float32)
    s[0, [10, 0, 5]] = [3.0, 2.0, 1.0]
    assert top_k(torch.from_numpy(s), 6)[1].tolist() == [[10, 0, 5, 1, 2, 3]]


def _check_recs(jrecs, trecs, user_col="user", jscores=None):
    """Equal recommendations; with ``jscores`` (the JAX package's scores
    of those users) an item may differ where its JAX score is the JAX
    item's within ``SCORE_RTOL`` (a near tie ordered by roundoff)."""
    np.testing.assert_array_equal(trecs[user_col], jrecs[user_col])
    ji, ti = jrecs["recommendations"], trecs["recommendations"]
    assert ti.dtype == ji.dtype and ti.shape == ji.shape
    if jscores is None:
        np.testing.assert_array_equal(ti, ji)
    else:
        rows, pos = np.nonzero(ti != ji)
        np.testing.assert_allclose(jscores[rows, ti[rows, pos]],
                                   jrecs["ratings"][rows, pos],
                                   rtol=SCORE_RTOL, atol=0)
        assert len(rows) <= ji.size // 100
    np.testing.assert_allclose(trecs["ratings"], jrecs["ratings"],
                               rtol=SCORE_RTOL, atol=0)


@pytest.mark.parametrize("kind,times,extra", FIT_CASES[:4])
def test_recommendations_and_predictions_are_the_references(kind, times,
                                                            extra):
    jm, tm, cols = _fit_both(kind, times, extra, seed=1)
    # integer-valued affinities: exact ties, no near ones
    near = jm._scores() if times else None
    for k in (1, 5, 30, 50):
        _check_recs(jm.recommend_for_all_users(k),
                    tm.recommend_for_all_users(k), jscores=near)
    users = np.array([3, 0, 3, 17, 39])
    _check_recs(jm.recommend_for_user_subset(JTable({"user": users}), 7),
                tm.recommend_for_user_subset(Table({"user": users}), 7),
                jscores=None if near is None else near[np.unique(users)])
    jp = jm.transform(JTable(dict(cols)))["prediction"]
    tp = tm.transform(Table(dict(cols)))["prediction"]
    assert tp.dtype == jp.dtype
    np.testing.assert_allclose(tp, jp, rtol=SCORE_RTOL, atol=0)


def test_transform_chunks_give_the_whole_call(monkeypatch):
    from synapseml_tpu_torch.recommendation import sar as tsar

    _, tm, cols = _fit_both("jaccard", None, {}, seed=2)
    whole = tm.transform(Table(dict(cols)))["prediction"]
    monkeypatch.setattr(tsar, "_TRANSFORM_USERS", 3)
    chunked = tm.transform(Table(dict(cols)))["prediction"]
    np.testing.assert_array_equal(chunked, whole)


def test_ranking_outputs_are_the_references():
    cols = _log_columns(3, users=20, items=15, n=200)
    adapters = {}
    for name, rec, tab, extra in (("jax", jrec, JTable, {}),
                                  ("torch", None, Table, {"device": CPU})):
        mod = rec if rec is not None else __import__(
            "synapseml_tpu_torch.recommendation", fromlist=["SAR"])
        adapter = mod.RankingAdapter(
            recommender=mod.SAR(supportThreshold=2, **extra), k=4)
        out = adapter.fit(tab(dict(cols))).transform(tab(dict(cols)))
        metrics = mod.RankingEvaluator(k=4, nItems=15).get_metrics(out)
        tvs = mod.RankingTrainValidationSplit(
            estimator=mod.SAR(supportThreshold=1, **extra),
            evaluator=mod.RankingEvaluator(k=3, metricName="ndcgAt"),
            estimatorParamMaps=[{"similarityFunction": "jaccard"},
                                {"similarityFunction": "lift"},
                                {"similarityFunction": "cooccurrence"}],
            trainRatio=0.7, seed=4).fit(tab(dict(cols)))
        adapters[name] = (out, metrics, tvs)
    (jo, jmet, jtvs), (to, tmet, ttvs) = adapters["jax"], adapters["torch"]
    for c in ("user", "prediction", "label"):
        assert [list(v) if isinstance(v, (list, np.ndarray)) else v
                for v in jo[c]] == [list(v) if isinstance(
                    v, (list, np.ndarray)) else v for v in to[c]], c
    assert jmet == tmet
    assert jtvs.get("bestParams") == ttvs.get("bestParams")
    assert jtvs.get("validationMetrics") == ttvs.get("validationMetrics")


def test_a_model_the_jax_package_saved_loads_and_converts(tmp_path):
    jm, _, cols = _fit_both("lift", "numeric", {}, seed=4)
    p = str(tmp_path / "jax_sar")
    jm.save(p)
    loaded = PipelineStage.load(p, device=CPU)
    assert isinstance(loaded, SARModel) and loaded.getDevice() == CPU
    carried = sar_model_from_reference(
        jm.get("itemSimilarity"), jm.get("userAffinity"),
        {"similarityFunction": "lift"}, device=CPU)
    want = jm.recommend_for_all_users(6)
    for model in (loaded, carried):
        assert model.get("itemSimilarity").tobytes() \
            == jm.get("itemSimilarity").tobytes()
        _check_recs(want, model.recommend_for_all_users(6))
