"""The port's isolation forest (``synapseml_tpu_torch/isolationforest``)
against the JAX package's, on the CPU:

* every scenario of ``tests/test_isolationforest.py`` on the port;
* the same seeded table through both packages: the forest arrays (``feat``,
  ``thresh``, ``left``, ``plen``) equal bit for bit (the same host draws in
  the same order), scores within ``SCORE_TOL`` (the mean path over trees
  is a float32 sum in another order: a few float32 roundings of paths near
  8, which ``2^(-mean / c)`` shrinks), labels equal but where a score lies
  within ``SCORE_TOL`` of the threshold;
* a model directory saved by the JAX package loads in the port and gives
  the same scores, and ``convert.iforest_model_from_reference`` carries a
  forest across with the same outputs.
"""

import numpy as np
import pytest

from synapseml_tpu.core.table import Table as JTable
from synapseml_tpu.isolationforest import IsolationForest as JIsolationForest

from synapseml_tpu_torch.convert import iforest_model_from_reference
from synapseml_tpu_torch.core.pipeline import PipelineStage
from synapseml_tpu_torch.core.table import Table
from synapseml_tpu_torch.isolationforest import (IsolationForest,
                                                 IsolationForestModel)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
SCORE_TOL = 1e-6
ARRAYS = ("feat", "thresh", "left", "plen")


def _X(n=300, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[:5] += 8.0  # obvious outliers
    return X


def _data(n=300, seed=0):
    return Table({"features": _X(n, seed)})


class TestIsolationForest:
    def test_outliers_score_higher(self):
        df = _data()
        model = IsolationForest(numEstimators=50, maxSamples=64.0,
                                randomSeed=7, device=CPU).fit(df)
        out = model.transform(df)
        s = out[model.getScoreCol()]
        assert s.shape == (300,)
        assert (0 <= s).all() and (s <= 1).all()
        top10 = np.argsort(-s)[:10]
        assert len(set(range(5)) & set(top10)) >= 4

    def test_contamination_thresholds_labels(self):
        df = _data()
        model = IsolationForest(numEstimators=50, maxSamples=64.0,
                                contamination=0.02, randomSeed=7,
                                device=CPU).fit(df)
        labels = model.transform(df)[model.getPredictionCol()]
        assert 1 <= labels.sum() <= 20
        m0 = IsolationForest(numEstimators=20, maxSamples=32.0,
                             device=CPU).fit(df)
        assert m0.transform(df)[m0.getPredictionCol()].sum() == 0

    def test_empty_rejected(self):
        with pytest.raises(ValueError, match="empty"):
            IsolationForest(device=CPU).fit(
                Table({"features": np.zeros((0, 3))}))

    def test_save_load(self, tmp_path):
        df = _data(100)
        model = IsolationForest(numEstimators=10, maxSamples=32.0,
                                randomSeed=1, device=CPU).fit(df)
        p = str(tmp_path / "iforest")
        model.save(p)
        loaded = PipelineStage.load(p)
        np.testing.assert_allclose(
            loaded.transform(df)[loaded.getScoreCol()],
            model.transform(df)[model.getScoreCol()])


def test_the_card_is_the_default_device():
    assert IsolationForest().getDevice() == "cuda"


PARAMS = [dict(numEstimators=30, maxSamples=64.0, contamination=0.05,
               randomSeed=7),
          dict(numEstimators=20, maxSamples=0.5, maxFeatures=0.5,
               bootstrap=True, contamination=0.02, randomSeed=3),
          dict(numEstimators=10, maxSamples=2.0, maxFeatures=2.0)]


def _check_same(jmodel, tmodel, X):
    jf, tf = jmodel.get("forest"), tmodel.get("forest")
    for k in ARRAYS:
        assert jf[k].dtype == tf[k].dtype, k
        np.testing.assert_array_equal(jf[k], tf[k], err_msg=k)
    assert jf["subSize"] == tf["subSize"]
    jout = jmodel.transform(JTable({"features": X}))
    tout = tmodel.transform(Table({"features": X}))
    js, ts = jout[jmodel.getScoreCol()], tout[tmodel.getScoreCol()]
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_TOL)
    if jf["threshold"] is None:
        assert tf["threshold"] is None
        return
    assert abs(tf["threshold"] - jf["threshold"]) <= SCORE_TOL
    near = np.abs(js - jf["threshold"]) <= SCORE_TOL
    jl, tl = jout[jmodel.getPredictionCol()], tout[tmodel.getPredictionCol()]
    np.testing.assert_array_equal(tl[~near], jl[~near])


@pytest.mark.parametrize("params", PARAMS)
def test_forest_and_scores_are_the_references(params):
    X = _X(200, seed=4)
    jmodel = JIsolationForest(**params).fit(JTable({"features": X}))
    tmodel = IsolationForest(device=CPU, **params).fit(
        Table({"features": X}))
    _check_same(jmodel, tmodel, X)


def test_walk_chunks_give_the_whole_walk(monkeypatch):
    from synapseml_tpu_torch.isolationforest import iforest as tiforest

    X = _X(257, seed=6)
    model = IsolationForest(numEstimators=12, maxSamples=32.0,
                            device=CPU).fit(Table({"features": X}))
    whole = model.transform(Table({"features": X}))[model.getScoreCol()]
    monkeypatch.setattr(tiforest, "_ROWS_PER_WALK", 50)
    chunked = model.transform(Table({"features": X}))[model.getScoreCol()]
    np.testing.assert_array_equal(chunked, whole)


def test_a_model_the_jax_package_saved_loads_and_converts(tmp_path):
    X = _X(150, seed=5)
    jmodel = JIsolationForest(numEstimators=15, maxSamples=32.0,
                              contamination=0.05, randomSeed=2,
                              scoreCol="s").fit(JTable({"features": X}))
    p = str(tmp_path / "jax_iforest")
    jmodel.save(p)
    loaded = PipelineStage.load(p, device=CPU)
    assert isinstance(loaded, IsolationForestModel)
    assert loaded.getScoreCol() == "s" and loaded.getDevice() == CPU
    _check_same(jmodel, loaded, X)
    carried = iforest_model_from_reference(
        jmodel.get("forest"), {"scoreCol": "s"}, device=CPU)
    _check_same(jmodel, carried, X)
