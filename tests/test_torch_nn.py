"""The port's nearest neighbours (``synapseml_tpu_torch/nn``) against the JAX
package's, on the CPU:

* every scenario of ``tests/test_nn.py`` on the port;
* exact queries on integer-valued keys (many tied scores): the same indices
  as the JAX package's ``jax.lax.top_k`` path (ties to the lower key index)
  and equal scores (integer sums are exact); conditioned queries with fewer
  admissible keys than k list their −inf entries in index order, as there;
* pruned queries equal exact ones, and the JAX package's pruned ones;
  a query batch split by ``SCORE_BYTES`` answers as the whole batch;
* a ``KNNModel`` and a ``ConditionalKNNModel`` the JAX package saved load
  in a process where importing ``jax`` or the JAX package fails (their
  pickled ball trees name the JAX package's classes; the loader maps them to
  the port's) and answer as the JAX models do; a pickle naming a class the
  port lacks raises ``NotImplementedError`` naming it;
* ``convert.balltree_from_reference`` rebuilds identical blocks.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from synapseml_tpu import nn as jnn
from synapseml_tpu.core.table import Table as JTable

from synapseml_tpu_torch.convert import balltree_from_reference
from synapseml_tpu_torch.core.pipeline import PipelineStage
from synapseml_tpu_torch.core.table import Table
from synapseml_tpu_torch.nn import (BallTree, ConditionalBallTree,
                                    ConditionalKNN, KNN, KNNModel)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _random_keys(n=200, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


def _int_keys(n, d, seed, lo=-2, hi=3):
    """Small integer keys: exact scores, with many ties."""
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n, d)).astype(np.float32)


class TestBallTree:
    def test_exact_vs_numpy(self):
        keys = _random_keys()
        tree = BallTree(keys, leaf_size=16, device=CPU)
        q = _random_keys(8, 16, seed=1)
        idx, scores = tree.query_batch(q, k=5)
        ref = q @ keys.T
        for r in range(len(q)):
            expect = np.argsort(-ref[r])[:5]
            np.testing.assert_array_equal(idx[r], expect)
            np.testing.assert_allclose(scores[r], ref[r][expect], rtol=1e-4)

    def test_single_query_api(self):
        keys = _random_keys(50)
        tree = BallTree(keys, values=[f"v{i}" for i in range(50)], device=CPU)
        matches = tree.find_maximum_inner_products(keys[7], k=1)
        assert matches[0].index == 7
        assert tree.values[matches[0].index] == "v7"

    def test_pruned_matches_exact(self):
        keys = _random_keys(3000, 8)
        tree = BallTree(keys, leaf_size=32, device=CPU)
        q = _random_keys(4, 8, seed=3)
        i_exact, s_exact = tree.query_batch(q, k=3, prune=False)
        i_pruned, s_pruned = tree.query_batch(q, k=3, prune=True)
        np.testing.assert_allclose(np.sort(s_pruned, axis=1),
                                   np.sort(s_exact, axis=1), rtol=1e-3)

    def test_save_load(self, tmp_path):
        keys = _random_keys(30)
        tree = BallTree(keys, device=CPU)
        p = str(tmp_path / "tree.pkl")
        tree.save(p)
        loaded = BallTree.load(p)
        np.testing.assert_array_equal(loaded.keys, tree.keys)


class TestConditionalBallTree:
    def test_conditioner_restricts(self):
        keys = _random_keys(100)
        labels = ["a" if i % 2 == 0 else "b" for i in range(100)]
        tree = ConditionalBallTree(keys, labels, device=CPU)
        matches = tree.find_maximum_inner_products(keys[1], {"a"}, k=5)
        for m in matches:
            assert labels[m.index] == "a"


class TestKNNEstimators:
    def test_knn_fit_transform(self):
        keys = _random_keys(64)
        df = Table({"features": keys,
                    "values": np.array([f"id{i}" for i in range(64)])})
        model = KNN(k=3, device=CPU).fit(df)
        col = model.transform(Table({"features": keys[:5]}))[
            model.getOutputCol()]
        assert len(col) == 5
        assert {"value", "distance"} <= set(col[0][0].keys())
        ref = keys[:5] @ keys.T
        for r in range(5):
            assert col[r][0]["value"] == f"id{np.argmax(ref[r])}"
        assert len(col[0]) == 3

    def test_conditional_knn(self):
        keys = _random_keys(60)
        labels = np.array(["x" if i < 30 else "y" for i in range(60)])
        df = Table({"features": keys, "values": np.arange(60),
                    "labels": labels})
        model = ConditionalKNN(k=4, device=CPU).fit(df)
        conds = np.empty(3, dtype=object)
        for i in range(3):
            conds[i] = ["y"]
        out = model.transform(Table({"features": keys[:3],
                                     "conditioner": conds}))
        for row in out[model.getOutputCol()]:
            for m in row:
                assert m["value"] >= 30

    def test_model_save_load(self, tmp_path):
        keys = _random_keys(40)
        df = Table({"features": keys, "values": np.arange(40)})
        model = KNN(k=2, device=CPU).fit(df)
        p = str(tmp_path / "knn_model")
        model.save(p)
        loaded = PipelineStage.load(p)
        out1 = model.transform(Table({"features": keys[:4]}))
        out2 = loaded.transform(Table({"features": keys[:4]}))
        for a, b in zip(out1[model.getOutputCol()], out2[loaded.getOutputCol()]):
            assert [m["distance"] for m in a] == [m["distance"] for m in b]


def test_the_card_is_the_default_device():
    assert KNN().getDevice() == "cuda"


# ---------------------------------------------------------------------------
# against the JAX package

def _same_blocks(jtree, ttree):
    assert jtree.num_blocks == ttree.num_blocks
    for a, b in zip(jtree._blocks, ttree._blocks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jtree._centers, ttree._centers)
    np.testing.assert_array_equal(jtree._radii, ttree._radii)


@pytest.mark.parametrize("k", [1, 7, 64])
def test_exact_queries_are_the_references(k):
    keys = _int_keys(300, 6, seed=1)
    q = _int_keys(20, 6, seed=2)
    jtree = jnn.BallTree(keys, leaf_size=16)
    ttree = BallTree(keys, leaf_size=16, device=CPU)
    _same_blocks(jtree, ttree)
    ji, js = jtree.query_batch(q, k, prune=False)
    ti, ts = ttree.query_batch(q, k, prune=False)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)


def test_conditioned_queries_are_the_references():
    keys = _int_keys(120, 5, seed=3)
    labels = [f"l{i % 7}" for i in range(120)]
    q = _int_keys(9, 5, seed=4)
    conds = [["l0"], ["l1", "l2"], ["none"], ["l3"], ["l4", "l5", "l6"],
             ["l0"], ["l6"], [], ["l2"]]
    jtree = jnn.ConditionalBallTree(keys, labels, leaf_size=8)
    ttree = ConditionalBallTree(keys, labels, leaf_size=8, device=CPU)
    for k in (3, 20, 40):                # 40 > the 18 keys of one label
        ji, js = jtree.query_batch_conditional(q, conds, k)
        ti, ts = ttree.query_batch_conditional(q, conds, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
    # fewer admissible keys than k: the -inf entries in index order
    ti, ts = ttree.query_batch_conditional(q[2:3], [["none"]], 6)
    assert ti.tolist() == [[0, 1, 2, 3, 4, 5]] and np.isneginf(ts).all()
    for jm, tm in zip(jtree.find_maximum_inner_products(q[1], ["l1"], k=30),
                      ttree.find_maximum_inner_products(q[1], ["l1"], k=30)):
        assert tuple(jm) == tuple(tm)


def test_pruned_queries_are_exact_and_the_references():
    keys = _random_keys(3000, 8, seed=5)
    q = _random_keys(16, 8, seed=6)
    jtree = jnn.BallTree(keys, leaf_size=32)
    ttree = BallTree(keys, leaf_size=32, device=CPU)
    _same_blocks(jtree, ttree)
    ti, ts = ttree.query_batch(q, 5, prune=True)
    ei, es = ttree.query_batch(q, 5, prune=False)
    ji, js = jtree.query_batch(q, 5, prune=True)
    np.testing.assert_array_equal(ti, ei)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ts, es, rtol=1e-6, atol=0)


def test_query_chunks_answer_as_the_whole_batch(monkeypatch):
    from synapseml_tpu_torch.nn import balltree as tball

    keys = _int_keys(500, 4, seed=7)
    q = _int_keys(33, 4, seed=8)
    tree = ConditionalBallTree(keys, [i % 3 for i in range(500)],
                               device=CPU)
    conds = [[i % 3] for i in range(33)]
    whole = tree.query_batch(q, 9), tree.query_batch_conditional(q, conds, 9)
    monkeypatch.setattr(tball, "SCORE_BYTES", 4 * 500 * 5)   # 5 queries
    chunked = tree.query_batch(q, 9), tree.query_batch_conditional(q, conds, 9)
    for (wi, ws), (ci, cs) in zip(whole, chunked):
        np.testing.assert_array_equal(ci, wi)
        np.testing.assert_array_equal(cs, ws)


def test_convert_rebuilds_the_blocks():
    keys = _random_keys(700, 6, seed=9)
    jtree = jnn.ConditionalBallTree(keys, list(range(700)),
                                    values=[f"v{i}" for i in range(700)],
                                    leaf_size=20)
    ttree = balltree_from_reference(jtree.keys, jtree.values,
                                    jtree.leaf_size, labels=jtree.labels,
                                    device=CPU)
    _same_blocks(jtree, ttree)
    q = _random_keys(5, 6, seed=10)
    ji, _ = jtree.query_batch(q, 4)
    np.testing.assert_array_equal(ttree.query_batch(q, 4)[0], ji)
    assert type(balltree_from_reference(keys, device=CPU)) is BallTree


_CHILD = """
import json, sys
import numpy as np
sys.modules["jax"] = None
sys.modules["synapseml_tpu"] = None
from synapseml_tpu_torch.core.pipeline import PipelineStage
from synapseml_tpu_torch.core.table import Table
d = sys.argv[1]
q = np.load(d + "/q.npy")
conds = json.load(open(d + "/conds.json"))
out = {}
for name in ("knn", "cknn"):
    m = PipelineStage.load(d + "/" + name, device="cpu")
    cols = {"features": q}
    if name == "cknn":
        c = np.empty(len(conds), dtype=object)
        c[:] = [list(x) for x in conds]
        cols["conditioner"] = c
    res = m.transform(Table(cols))[m.getOutputCol()]
    out[name] = [type(m).__module__ + "." + type(m).__name__,
                 type(m.getBallTree()).__module__,
                 [[[str(x["value"]), float(x["distance"])] for x in row]
                  for row in res]]
try:
    PipelineStage.load(d + "/unported", device="cpu")
    out["unported"] = "loaded"
except NotImplementedError as e:
    out["unported"] = str(e)
out["bad"] = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and (m == "jax" or m.startswith("jax.")
                         or m == "synapseml_tpu"
                         or m.startswith("synapseml_tpu.")))
print(json.dumps(out))
"""


def _rows(col):
    return [[[str(x["value"]), float(x["distance"])] for x in row]
            for row in col]


def test_models_the_jax_package_saved_load_without_it(tmp_path):
    keys = _int_keys(90, 5, seed=11)
    labels = np.array([f"l{i % 4}" for i in range(90)])
    values = np.array([f"id{i}" for i in range(90)])
    q = _int_keys(6, 5, seed=12)
    conds = [["l0"], ["l1", "l3"], ["missing"], ["l2"], ["l0", "l1"], ["l3"]]
    df = JTable({"features": keys, "values": values, "labels": labels})
    knn = jnn.KNN(k=4, outputCol="nbrs").fit(df)
    cknn = jnn.ConditionalKNN(k=30, outputCol="nbrs").fit(df)
    knn.save(str(tmp_path / "knn"))
    cknn.save(str(tmp_path / "cknn"))
    np.save(tmp_path / "q.npy", q)
    (tmp_path / "conds.json").write_text(json.dumps(conds))
    # a stage whose pickled complex param names a class the port lacks
    stage = KNNModel(k=1, device=CPU)
    stage.save(str(tmp_path / "unported"))
    cp = tmp_path / "unported" / "complexParams"
    cp.mkdir(exist_ok=True)
    (cp / "ballTree.pkl").write_bytes(
        b"\x80\x04csynapseml_tpu.nn.balltree\nRetiredTree\n.")
    (cp / "index.json").write_text(json.dumps([["ballTree", "pickle"]]))

    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["knn"][:2] == ["synapseml_tpu_torch.nn.knn.KNNModel",
                              "synapseml_tpu_torch.nn.balltree"]
    assert got["cknn"][0] == "synapseml_tpu_torch.nn.knn.ConditionalKNNModel"
    assert got["knn"][2] == _rows(
        knn.transform(JTable({"features": q}))["nbrs"])
    c = np.empty(len(conds), dtype=object)
    c[:] = conds
    assert got["cknn"][2] == _rows(cknn.transform(
        JTable({"features": q, "conditioner": c}))["nbrs"])
    assert "synapseml_tpu.nn.balltree.RetiredTree" in got["unported"]
    # the stage's own pickle module is untouched: plain pickles still load
    assert pickle.loads(pickle.dumps(np.arange(3))).tolist() == [0, 1, 2]


def test_knn_models_load_in_process_with_the_same_answers(tmp_path):
    keys = _random_keys(80, 6, seed=13)
    df = JTable({"features": keys, "values": np.arange(80)})
    jm = jnn.KNN(k=3).fit(df)
    jm.save(str(tmp_path / "knn"))
    loaded = PipelineStage.load(str(tmp_path / "knn"), device=CPU)
    assert isinstance(loaded, KNNModel) and loaded.getDevice() == CPU
    assert isinstance(loaded.getBallTree(), BallTree)
    _same_blocks(jm.getBallTree(), loaded.getBallTree())
    got = _rows(loaded.transform(Table({"features": keys[:7]}))[
        loaded.getOutputCol()])
    want = _rows(jm.transform(JTable({"features": keys[:7]}))[
        jm.getOutputCol()])
    # float keys: the same neighbours, inner products to float32 roundoff
    assert [[v for v, _ in row] for row in got] \
        == [[v for v, _ in row] for row in want]
    np.testing.assert_allclose([[d for _, d in row] for row in got],
                               [[d for _, d in row] for row in want],
                               rtol=1e-6, atol=0)
