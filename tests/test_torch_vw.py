"""The port's VW against the JAX package's, on the same seeded inputs (CPU):

* murmur3, the feature hashes (the port's numpy-vectorised batch hashing
  included), the featurizers and the VW text parser: bit for bit;
* ``train_vw`` — weights, bias, progressive predictions and progressive
  loss — for every loss, adaptive or not, with l1/l2, ``--noconstant``,
  sample weights and several passes, and the contextual-bandit estimator.
  Within ``W_TOL`` of the largest weight (predictions: of the largest
  prediction; the progressive loss: relative), not bit for bit: the two
  packages sum rows, batches and repeated scatter indices in other orders
  (XLA contracts products into fused multiply-adds and folds long sums in
  vector lanes) and take ``exp`` / ``log1p`` from other libraries; at these
  sizes the gaps are about 1e-6 of the largest weight;
* the mesh path (``train_vw(mesh=)``) on 4 gloo CPU ranks, each given the
  whole table (single controller) and each given only its rows
  (multi-controller), against the JAX package's 4-device CPU mesh, with
  two sync segments a pass;
* the estimators' predictions, ``policyeval``'s estimates and intervals,
  the DSJson and CSE transformers;
* ``VWState`` snapshots cross-loaded both ways through a
  ``CheckpointStore`` and through ``convert``.

The JAX package is imported inside the parent-side functions only: the
spawned ranks import this module to find ``_mesh_rank``.
"""

from __future__ import annotations

import json
import os
import pickle
import random

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.core.table import Table as TTable
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
W_TOL = 1e-5          # of max |w|: weights and predictions across packages
LOSS_TOL = 1e-5       # relative: the progressive loss
MESH_RANKS = 4


def _rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _sparse_table(n=1500, p=12, bits=10, seed=0):
    """Seeded padded sparse rows: a feature shared by every row (repeated
    scatter indices inside a batch), hash-collision-sized index space and
    zero-valued padding slots."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << bits, (n, p)).astype(np.int32)
    idx[:, 0] = 5
    val = rng.normal(size=(n, p)).astype(np.float32)
    val[:, -2:] = 0.0
    y = rng.normal(size=n).astype(np.float32)
    ypm = np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32)
    sw = (rng.random(n) + 0.5).astype(np.float32)
    return idx, val, y, ypm, sw


# ---------------------------------------------------------------------------
# hashing, featurizers, text parsing: bit for bit
# ---------------------------------------------------------------------------

def _names(seed=0, n=600):
    r = random.Random(seed)
    alphabet = "abcXYZ0123_=é日 -"
    out = ["".join(r.choice(alphabet) for _ in range(r.randint(0, 17)))
           for _ in range(n)]
    out += [str(r.randint(-10 ** 12, 10 ** 12)) for _ in range(60)]
    out += ["-", "007", "-0", str(1 << 40), str((1 << 40) + 1)]
    return out


@pytest.mark.parametrize("seed", [0, 77, 0xFFFFFFFF])
def test_murmur3_and_feature_hashes_are_the_references(seed):
    from synapseml_tpu.vw import hashing as jh
    from synapseml_tpu_torch.vw import hashing as th

    names = _names(seed & 0xFF)
    data = [s.encode("utf-8") for s in names]
    assert [th.murmur3_32(d, seed) for d in data] == \
        [jh.murmur3_32(d, seed) for d in data]
    np.testing.assert_array_equal(
        th.murmur3_32_batch(data, seed).astype(np.int64),
        [jh.murmur3_32(d, seed) for d in data])
    for bits in (None, 18, 24):
        np.testing.assert_array_equal(th.hash_strings(names, seed, bits),
                                      jh.hash_strings(names, seed, bits))
        np.testing.assert_array_equal(th.hash_strings(names[:10], seed, bits),
                                      jh.hash_strings(names[:10], seed, bits))
    assert [th.hash_feature(s, seed) for s in names] == \
        [jh.hash_feature(s, seed) for s in names]
    assert [th.namespace_hash(s, seed) for s in names[:50]] == \
        [jh.namespace_hash(s, seed) for s in names[:50]]
    pairs = list(zip(range(0, 2 ** 32, 2 ** 26), range(7, 999, 15)))
    assert [th.interaction_hash(a, b) for a, b in pairs] == \
        [jh.interaction_hash(a, b) for a, b in pairs]


def _featurizer_table(Table, n=40, seed=1):
    rng = np.random.default_rng(seed)
    tags = np.empty(n, object)        # ragged lists of strings, some None
    tags[:] = [None if i % 7 == 0 else
               [f"t{int(j)}" for j in rng.integers(0, 5, 1 + i % 3)]
               for i in range(n)]
    return Table({
        "age": rng.integers(0, 90, n).astype(np.float64),
        "flag": rng.random(n) > 0.5,
        "city": np.array([f"c{int(i)}" for i in rng.integers(0, 9, n)],
                         object),
        "tags": tags,
        "vec": rng.normal(size=(n, 4)).astype(np.float32)
        * (rng.random((n, 4)) > 0.3)})


@pytest.mark.parametrize("params", [
    dict(), dict(numBits=6), dict(hashSeed=12, sumCollisions=False),
    dict(prefixStringsWithColumnName=False)])
def test_featurizer_and_interactions_are_the_references(params):
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu.vw import featurizer as jf
    from synapseml_tpu_torch.vw import featurizer as tf

    cols = ["age", "flag", "city", "tags", "vec"]
    out = {}
    for name, mod, Table in (("jax", jf, JTable), ("torch", tf, TTable)):
        t = _featurizer_table(Table)
        a = mod.VowpalWabbitFeaturizer(inputCols=cols[:3], outputCol="a",
                                       **params).transform(t)
        b = mod.VowpalWabbitFeaturizer(inputCols=cols[3:], outputCol="b",
                                       **params).transform(a)
        c = mod.VowpalWabbitInteractions(
            inputCols=["a", "b"], numBits=params.get("numBits", 18),
            sumCollisions=params.get("sumCollisions", True)).transform(b)
        out[name] = (b["a"], b["b"], c["interactions"])
    for got, want in zip(out["torch"], out["jax"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _vw_lines(n=120, seed=2):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        x1, x2 = rng.normal(), rng.normal()
        lab = 1 if x1 - x2 > 0 else -1
        imp = f" {rng.random() + 0.5:.3f}" if i % 3 == 0 else ""
        tag = f" 'ex{i}" if i % 5 == 0 else ""
        lines.append(f"{lab}{imp}{tag} |a:2 x1:{x1:.4f} word{i % 7} "
                     f"|b x2:{x2:.4f} {i % 4} |c z")
    lines += ["|a x:1", " |b y:-2.5 ", "-1 |a 12 -3 w:0"]
    return lines


@pytest.mark.parametrize("inter,ignore,seed", [((), "", 0),
                                               (("ab",), "", 3),
                                               (("ab", "bc"), "c", 0)])
def test_text_parser_is_the_references(inter, ignore, seed):
    from synapseml_tpu.vw import textparse as jt
    from synapseml_tpu_torch.vw import textparse as tt

    lines = _vw_lines()
    for line in lines[:20]:
        assert tt.parse_example(line, 18, inter, seed, ignore) == \
            jt.parse_example(line, 18, inter, seed, ignore)
    got = tt.parse_lines(lines, 18, inter, seed, ignore)
    want = jt.parse_lines(lines, 18, inter, seed, ignore)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the learner
# ---------------------------------------------------------------------------

CASES = [(loss, extra) for loss in ("squared", "logistic", "hinge",
                                    "quantile")
         for extra in (dict(), dict(adaptive=False),
                       dict(l1=1e-4, l2=1e-3), dict(no_constant=True))] + [
    ("quantile", dict(quantile_tau=0.8, power_t=0.3, initial_t=2.0,
                      adaptive=False)),
    ("squared", dict(num_passes=3, batch_size=7)),
    ("logistic", dict(learning_rate=2.0, num_bits=6))]


def _compare_states(ts, js, tol=W_TOL):
    jw, tw = np.asarray(js.weights), ts.weights.numpy()
    assert tw.shape == jw.shape and tw.dtype == jw.dtype
    assert _rel_gap(tw, jw) <= tol
    assert _rel_gap(ts.acc.numpy(), np.asarray(js.acc)) <= tol
    for k in ("bias", "bias_acc", "t", "loss_sum", "weight_sum"):
        got, want = float(getattr(ts, k)), float(getattr(js, k))
        assert abs(got - want) <= tol * max(1.0, abs(want)), k


@pytest.mark.parametrize("loss,extra", CASES)
def test_train_vw_matches_the_reference(loss, extra):
    from synapseml_tpu.vw import learner as J
    from synapseml_tpu_torch.vw import learner as T

    idx, val, y, ypm, sw = _sparse_table()
    cfg = dict(num_bits=10, loss_function=loss, batch_size=64, num_passes=2)
    cfg.update(extra)
    idx = idx & ((1 << cfg["num_bits"]) - 1)     # hashed into the table
    lab = ypm if loss in ("logistic", "hinge") else y
    js, jp = J.train_vw(idx, val, lab, J.VWConfig(**cfg), sample_weight=sw,
                        collect_progressive=True)
    ts, tp = T.train_vw(idx, val, lab, T.VWConfig(**cfg), sample_weight=sw,
                        collect_progressive=True, device=CPU)
    _compare_states(ts, js)
    assert tp.shape == jp.shape and _rel_gap(tp, jp) <= W_TOL
    assert abs(ts.progressive_loss - js.progressive_loss) <= \
        LOSS_TOL * abs(js.progressive_loss)
    if extra.get("no_constant"):
        assert float(ts.bias) == 0.0
    for link in ("identity", "logistic"):
        got = T.vw_predict(ts, idx[:50], val[:50], link)
        want = np.asarray(J.vw_predict(js, idx[:50], val[:50], link))
        assert _rel_gap(got, want) <= W_TOL


@pytest.mark.parametrize("bad", [1 << 10, -1])
def test_indices_outside_the_table_are_refused(bad):
    """An unhashed index would assert on the card (and clamp in the JAX
    package's gather): the port refuses it before the pass."""
    from synapseml_tpu_torch.vw import learner as T

    idx, val, y, _, _ = _sparse_table(n=100)
    idx[7, 3] = bad
    cfg = T.VWConfig(num_bits=10)
    with pytest.raises(ValueError, match="2\\*\\*num_bits"):
        T.train_vw(idx, val, y, cfg, device=CPU)
    state, _ = T.train_vw(idx[:7], val[:7], y[:7], cfg, device=CPU)
    with pytest.raises(ValueError, match="mask the hashes"):
        T.vw_predict(state, idx, val)


def test_softplus_is_jax_logaddexp():
    """The logistic loss's softplus is ``logaddexp(x, 0)`` as in
    ``jax.nn.softplus``, not PyTorch's thresholded one."""
    import jax.numpy as jnp

    from synapseml_tpu_torch.vw.learner import _softplus

    x = np.array([-200.0, -30.0, -1.0, 0.0, 1e-8, 1.0, 19.0, 21.0, 30.0,
                  90.0, 200.0], np.float32)
    got = _softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.logaddexp(jnp.asarray(x), 0.0))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    assert np.isfinite(got).all()


def test_warm_start_continues_the_reference_state():
    """A JAX-trained state carried across (``convert``) and trained on by
    the port gives the JAX package's continued state."""
    from synapseml_tpu.vw import learner as J
    from synapseml_tpu_torch.convert import (vw_state_arrays,
                                             vw_state_from_reference)
    from synapseml_tpu_torch.vw import learner as T

    idx, val, y, _, sw = _sparse_table(seed=3)
    cfg = dict(num_bits=10, batch_size=32)
    first, _ = J.train_vw(idx[:600], val[:600], y[:600], J.VWConfig(**cfg))
    js, _ = J.train_vw(idx[600:], val[600:], y[600:], J.VWConfig(**cfg),
                       sample_weight=sw[600:], initial_state=first)
    start = vw_state_from_reference(vw_state_arrays(first), CPU)
    ts, _ = T.train_vw(idx[600:], val[600:], y[600:], T.VWConfig(**cfg),
                       sample_weight=sw[600:], initial_state=start)
    _compare_states(ts, js)
    # the initial state is copied, never trained in place
    np.testing.assert_array_equal(start.weights.numpy(),
                                  np.asarray(first.weights))


def test_state_snapshots_cross_load_both_ways(tmp_path):
    from synapseml_tpu.core.checkpoint import CheckpointStore as JStore
    from synapseml_tpu.vw import learner as J
    from synapseml_tpu_torch.core.checkpoint import CheckpointStore as TStore
    from synapseml_tpu_torch.convert import vw_state_arrays
    from synapseml_tpu_torch.vw import learner as T

    idx, val, y, _, _ = _sparse_table(n=300)
    js, _ = J.train_vw(idx, val, y, J.VWConfig(num_bits=10))
    ts, _ = T.train_vw(idx, val, y, T.VWConfig(num_bits=10), device=CPU)
    # JAX → port through the JAX package's store
    js.save_to_store(JStore(str(tmp_path / "j")), 3, meta={"by": "jax"})
    got, ckpt = T.VWState.load_from_store(TStore(str(tmp_path / "j")),
                                          device=CPU)
    assert ckpt.step == 3 and ckpt.meta["by"] == "jax"
    for k, v in vw_state_arrays(js).items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v)
    # port → JAX through the port's store
    ts.save_to_store(TStore(str(tmp_path / "t")), 5)
    back, ckpt = J.VWState.load_from_store(JStore(str(tmp_path / "t")))
    assert ckpt.step == 5
    for k, v in vw_state_arrays(ts).items():
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), v)
    # the bytes themselves carry the same npz members and dtypes
    assert T.VWState.from_bytes(js.to_bytes(), CPU).arrays().keys() == \
        vw_state_arrays(js).keys()
    with pytest.raises(ValueError, match="not a valid npz"):
        T.VWState.from_bytes(b"garbage", CPU)


# ---------------------------------------------------------------------------
# the mesh path on gloo ranks
# ---------------------------------------------------------------------------

MESH_CASES = [dict(loss_function="squared", sync_splits=2, num_passes=2),
              dict(loss_function="logistic", sync_splits=2, adaptive=False),
              dict(loss_function="hinge", sync_splits=3, l2=1e-3)]


def _mesh_rank(rank: int, workdir: str, world: int) -> None:
    """One gloo CPU rank: ``train_vw(mesh=)`` on each case, first with
    the whole table (single controller), then with only this rank's rows
    (multi-controller); rank 0 writes the states."""
    import torch.distributed as dist

    from synapseml_tpu_torch.parallel import mesh as pmesh
    from synapseml_tpu_torch.vw import learner as T

    torch.set_num_threads(1)
    pmesh.init_distributed("gloo", os.path.join(workdir, "store"), rank,
                           world, timeout_s=120)
    mesh = pmesh.make_mesh({"data": world}, device=CPU)
    d = np.load(os.path.join(workdir, "inputs.npz"))
    idx, val, y, ypm, sw = (d[k] for k in ("idx", "val", "y", "ypm", "sw"))
    out = {}
    for i, case in enumerate(MESH_CASES):
        cfg = T.VWConfig(num_bits=10, batch_size=32, **case)
        lab = ypm if case["loss_function"] != "squared" else y
        st, _ = T.train_vw(idx, val, lab, cfg, sample_weight=sw, mesh=mesh)
        out[f"single{i}"] = st.arrays()
        # each process passes only its own rows (the multi-controller
        # contract of initialize_distributed, with one rank per process)
        pmesh._MULTI_CONTROLLER["on"] = True
        try:
            blk = idx.shape[0] // world
            rows = slice(rank * blk, (rank + 1) * blk)
            st, _ = T.train_vw(idx[rows], val[rows], lab[rows], cfg,
                               sample_weight=sw[rows], mesh=mesh)
        finally:
            pmesh._MULTI_CONTROLLER["on"] = False
        out[f"multi{i}"] = st.arrays()
    if rank == 0:
        with open(os.path.join(workdir, "states.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_states(tmp_path_factory):
    """(the ranks' states, the JAX package's 4-device mesh states): the
    spawn runs while the parent trains the JAX side."""
    import jax
    import torch.multiprocessing as mp

    from synapseml_tpu.parallel import make_mesh
    from synapseml_tpu.vw import learner as J

    workdir = str(tmp_path_factory.mktemp("vw_mesh"))
    # 32-row batches: the blocks of 4 ranks split evenly into batches
    idx, val, y, ypm, sw = _sparse_table(n=MESH_RANKS * 32 * 6, seed=5)
    np.savez(os.path.join(workdir, "inputs.npz"), idx=idx, val=val, y=y,
             ypm=ypm, sw=sw)
    ctx = mp.start_processes(_mesh_rank, args=(workdir, MESH_RANKS),
                             nprocs=MESH_RANKS, join=False,
                             start_method="spawn")
    mesh = make_mesh({"data": MESH_RANKS}, devices=jax.devices()[:MESH_RANKS])
    want = []
    for case in MESH_CASES:
        lab = ypm if case["loss_function"] != "squared" else y
        st, _ = J.train_vw(idx, val, lab,
                           J.VWConfig(num_bits=10, batch_size=32, **case),
                           sample_weight=sw, mesh=mesh)
        want.append({k: np.asarray(getattr(st, k))
                     for k in J.VWState._FIELDS})
    while not ctx.join(timeout=120):
        pass
    with open(os.path.join(workdir, "states.pkl"), "rb") as f:
        return pickle.load(f), want


@pytest.mark.parametrize("case", range(len(MESH_CASES)))
@pytest.mark.parametrize("contract", ["single", "multi"])
def test_mesh_path_on_gloo_ranks_matches_the_reference_mesh(mesh_states,
                                                            case, contract):
    from synapseml_tpu_torch.vw.learner import VWState

    got, want = mesh_states
    ts = VWState.from_arrays(got[f"{contract}{case}"], CPU)
    js = VWState.from_arrays(want[case], CPU)
    _compare_states(ts, js)
    # pmean'd weights, psum'd progressive sums: every row counted once
    assert float(ts.weight_sum) == pytest.approx(float(js.weight_sum),
                                                 rel=1e-6)


# ---------------------------------------------------------------------------
# the estimators and policy evaluation
# ---------------------------------------------------------------------------

def _dense_table(Table, n=300, seed=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = (X @ np.array([1.0, -1.0, 2.0, 0.5, 0.0], np.float32) + 0.3
         ).astype(np.float32)
    return Table({"features": X, "label": y,
                  "bin": (y > 0).astype(np.float32),
                  "w": (rng.random(n) + 0.5).astype(np.float32)})


@pytest.mark.parametrize("kind,params", [
    ("VowpalWabbitClassifier", dict(labelCol="bin", numPasses=3)),
    ("VowpalWabbitClassifier", dict(labelCol="bin", weightCol="w",
                                    passThroughArgs="--sgd -l 0.3")),
    ("VowpalWabbitRegressor", dict(numPasses=3)),
    ("VowpalWabbitRegressor", dict(lossFunction="quantile",
                                   passThroughArgs="--noconstant --l2 1e-3")),
    ("VowpalWabbitRegressor", dict(batchSize=16, numBits=4))])
def test_estimators_predict_as_the_reference(kind, params):
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu import vw as jvw
    from synapseml_tpu_torch import vw as tvw

    jm = getattr(jvw, kind)(**params).fit(_dense_table(JTable))
    tm = getattr(tvw, kind)(device=CPU, **params).fit(_dense_table(TTable))
    jo, to = jm.transform(_dense_table(JTable)), tm.transform(
        _dense_table(TTable))
    for col in ("prediction", "probability", "rawPrediction"):
        if col in jo:
            want = np.asarray(jo[col], np.float64)
            got = np.asarray(to[col], np.float64)
            if col == "prediction" and kind.endswith("Classifier"):
                margin = np.abs(np.asarray(jo["rawPrediction"])) > 1e-4
                np.testing.assert_array_equal(got[margin], want[margin])
            else:
                assert _rel_gap(got, want) <= W_TOL, col
    jst, tst = jm.getPerformanceStatistics(), tm.getPerformanceStatistics()
    assert tst["examples"] == pytest.approx(jst["examples"], rel=1e-6)
    assert tst["progressiveLoss"] == pytest.approx(jst["progressiveLoss"],
                                                   rel=LOSS_TOL)


def test_generic_and_progressive_predict_as_the_reference():
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu import vw as jvw
    from synapseml_tpu_torch import vw as tvw

    lines = np.array(_vw_lines(200, seed=8), object)
    args = "--loss_function logistic --passes 3 -q ab"
    jm = jvw.VowpalWabbitGeneric(passThroughArgs=args).fit(
        JTable({"value": lines}))
    tm = tvw.VowpalWabbitGeneric(passThroughArgs=args, device=CPU).fit(
        TTable({"value": lines}))
    assert _rel_gap(tm.transform(TTable({"value": lines}))["prediction"],
                    jm.transform(JTable({"value": lines}))["prediction"]) \
        <= W_TOL
    jp = jvw.VowpalWabbitGenericProgressive().transform(
        JTable({"value": lines}))["prediction"]
    tp = tvw.VowpalWabbitGenericProgressive(device=CPU).transform(
        TTable({"value": lines}))["prediction"]
    assert _rel_gap(tp, jp) <= W_TOL


def _cb_rows(make_sparse_batch, n=200, k=3, seed=9):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        ctx = rng.normal()
        actions = [make_sparse_batch([[a + 1, 10 + a]], [[1.0, ctx]])[0]
                   for a in range(k)]
        chosen = int(rng.integers(1, k + 1))
        best = 2 if ctx > 0 else 0
        rows.append({"features": actions, "chosenAction": chosen,
                     "label": 0.0 if chosen - 1 == best else 1.0,
                     "probability": float(rng.choice([1.0 / k, 0.5]))})
    return rows


@pytest.mark.parametrize("cb_type", ["ips", "mtr"])
def test_contextual_bandit_predicts_as_the_reference(cb_type):
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu import vw as jvw
    from synapseml_tpu.vw.learner import make_sparse_batch as jmsb
    from synapseml_tpu_torch import vw as tvw
    from synapseml_tpu_torch.vw.learner import make_sparse_batch as tmsb

    jdf = JTable.from_rows(_cb_rows(jmsb))
    tdf = TTable.from_rows(_cb_rows(tmsb))
    jo = jvw.VowpalWabbitContextualBandit(numPasses=3, cbType=cb_type).fit(
        jdf).transform(jdf)
    to = tvw.VowpalWabbitContextualBandit(numPasses=3, cbType=cb_type,
                                          device=CPU).fit(tdf).transform(tdf)
    for i in range(tdf.num_rows):
        assert _rel_gap(to["scores"][i], jo["scores"][i]) <= W_TOL
    agree = np.asarray(to["chosenActionPrediction"]) == \
        np.asarray(jo["chosenActionPrediction"])
    assert agree.mean() >= 0.99          # only near-ties may flip


def test_policy_evaluation_is_the_references():
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu import vw as jvw
    from synapseml_tpu_torch import vw as tvw

    rng = np.random.default_rng(10)
    n = 1500
    act = rng.integers(0, 2, n)
    p_log = np.where(act == 0, 0.4, 0.6)
    p_tgt = (act == 0).astype(np.float64) * 0.9 + 0.05
    reward = np.where(act == 0, rng.random(n) < 0.7,
                      rng.random(n) < 0.2).astype(float)
    count = rng.integers(1, 3, n)
    for fn in ("ips_estimate", "snips_estimate"):
        assert getattr(tvw, fn)(reward, p_log, p_tgt) == \
            getattr(jvw, fn)(reward, p_log, p_tgt)
        assert getattr(tvw, fn)(reward, p_log, p_tgt, count) == \
            getattr(jvw, fn)(reward, p_log, p_tgt, count)
    assert tvw.cressie_read_estimate(reward, p_log, p_tgt) == \
        jvw.cressie_read_estimate(reward, p_log, p_tgt)
    for alpha in (0.01, 0.05, 0.3):
        assert tvw.cressie_read_interval(reward, p_log, p_tgt, alpha) == \
            jvw.cressie_read_interval(reward, p_log, p_tgt, alpha)
    assert tvw.cressie_read_interval(reward[:0], p_log[:0], p_tgt[:0]) == \
        jvw.cressie_read_interval(reward[:0], p_log[:0], p_tgt[:0])
    s_t, s_j = tvw.KahanSum(), jvw.KahanSum()
    for v in reward * 0.1:
        s_t.add(v)
        s_j.add(v)
    assert float(s_t) == float(s_j)

    lines = [json.dumps({"EventId": f"e{i}", "_label_cost": -float(i % 3),
                         "_label_probability": 0.25 + 0.5 * (i % 2),
                         "_labelIndex": i % 2, "a": [1, 2],
                         "p": [0.5, 0.5]}) for i in range(12)]
    out = {}
    for name, mod, Table in (("jax", jvw, JTable), ("torch", tvw, TTable)):
        parsed = mod.VowpalWabbitDSJsonTransformer().transform(
            Table({"value": np.array(lines, object)}))
        parsed["reward"] = -parsed["cost"]
        parsed["probabilityPredicted"] = np.linspace(0.1, 0.9, 12)
        summary = mod.VowpalWabbitCSETransformer().transform(parsed)
        out[name] = ({c: np.asarray(parsed[c]).tolist()
                      for c in parsed.columns},
                     {c: np.asarray(summary[c]).tolist()
                      for c in summary.columns})
    assert out["torch"] == out["jax"]
