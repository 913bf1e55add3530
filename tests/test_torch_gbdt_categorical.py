"""Categorical and sparse (CSR) data in the port against the JAX package:
binning (identity bins of categorical columns, CSR entries scattered into
the bins of an all-zero row), the categorical split search of both growth
policies (one-vs-rest and many-vs-many, the categorical knobs, beside a
monotone numeric column, under bagging, binary and multiclass), the
independent oracle of ``tests/gbdt_oracle.py``, and what a categorical
booster gives: model strings, the JSON dump's ``"a||b"`` thresholds, SHAP,
a reload, CSR scoring, validation with early stopping and the estimators'
categorical params.

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``device="cpu"``, where every histogram goes through the
plain PyTorch version of its CUDA kernel. The JAX fits get a callback that
does nothing (its host loop, one grower compile per config). Tolerances,
each with its reason:

* bins, bin mappers, tree structure (``split_type`` and ``cat_bitset``
  included), ``best_iteration``: exact (the same integer decisions from
  histograms that agree to the last bits);
* leaf values, raw scores and the validation metric: 1e-5 / 1e-6 (float32
  sums in another order, as in ``test_torch_gbdt_family.py``);
* a booster carried across by ``convert``: model string and JSON dump
  byte-identical, SHAP within 1e-6 of the largest |phi|;
* the estimators: predictions within 1e-6.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from synapseml_tpu.core import Table as JTable
from synapseml_tpu.core import assemble_features as j_assemble
from synapseml_tpu.gbdt import boosting as jboost
from synapseml_tpu.gbdt import dataset as jdataset
from synapseml_tpu.models import LightGBMClassifier as JClassifier
from synapseml_tpu.ops import quantize as jq

from synapseml_tpu_torch.convert import booster_arrays, booster_from_reference
from synapseml_tpu_torch.core import Table, assemble_features
from synapseml_tpu_torch.gbdt import boosting as tboost
from synapseml_tpu_torch.gbdt import dataset as tdataset
from synapseml_tpu_torch.models import LightGBMClassifier
from synapseml_tpu_torch.ops import quantize as tq
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
N = 3000
CATS = [0, 1]          # 4 categories (one-vs-rest) and 40 (many-vs-many)
LEAF_TOL = 1e-5
METRIC_TOL = 1e-6
POLICIES = ("leafwise", "depthwise")
BASE = dict(num_iterations=4, num_leaves=15, min_data_in_leaf=10,
            min_data_per_group=30)


def _host_loop(it, trees):
    """Does nothing: keeps a JAX fit on its host loop."""


def _data(n: int = N, seed: int = 0, kind: str = "binary"):
    """(X, y): column 0 holds 4 categories, column 1 40 (with NaN and a
    negative id, both binned to 0), columns 2-4 are numeric (3 with NaN);
    the label follows per-category offsets, so category sets win
    splits."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    X[:, 0] = rng.integers(0, 4, n)
    X[:, 1] = rng.integers(0, 40, n)
    X[rng.random(n) < 0.03, 1] = np.nan
    X[rng.random(n) < 0.02, 1] = -1.0
    X[rng.random(n) < 0.05, 3] = np.nan
    o0 = rng.normal(size=4).astype(np.float32)
    o1 = 1.5 * rng.normal(size=40).astype(np.float32)
    c1 = np.clip(np.nan_to_num(X[:, 1]), 0, 39).astype(int)
    z = (o0[X[:, 0].astype(int)] + o1[c1] + 0.7 * X[:, 4]
         + 0.4 * rng.normal(size=n)).astype(np.float32)
    if kind == "multiclass":
        return X, np.digitize(z, [-0.7, 0.7]).astype(np.float32)
    return X, (z > 0).astype(np.float32)


def _csr(X: np.ndarray):
    """CSR of ``X`` with about half of the numeric entries zeroed, so the
    implicit-zero bins matter (categorical column 1 keeps its NaNs
    explicit)."""
    X = X.copy()
    rng = np.random.default_rng(9)
    X[rng.random(X.shape) < 0.5] = 0.0
    return X, sp.csr_matrix(X)


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

def _assert_same_mapper(tm, jm):
    for f in ("boundaries", "num_bins", "is_categorical", "has_nan",
              "cat_counts"):
        np.testing.assert_array_equal(np.asarray(getattr(tm, f)),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    assert tm.max_bin == jm.max_bin


BIN_CASES = {
    # ids past max_bin share the overflow bin
    "above-max-bin": dict(values=lambda r, n: r.integers(0, 600, n),
                          max_bin=255),
    "negative": dict(values=lambda r, n: r.integers(-5, 20, n), max_bin=63),
    "non-integer": dict(values=lambda r, n: r.uniform(-1.5, 30.5, n),
                        max_bin=63),
    "nan": dict(values=lambda r, n: np.where(r.random(n) < 0.2, np.nan,
                                             r.integers(0, 9, n)),
                max_bin=16),
    "sparse-ids": dict(values=lambda r, n: r.choice([0, 3, 17, 200], n),
                       max_bin=255),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_categorical_binning_matches_the_reference(case):
    spec = BIN_CASES[case]
    rng = np.random.default_rng(1)
    X = rng.normal(size=(2000, 3)).astype(np.float32)
    X[:, 1] = spec["values"](rng, 2000)
    X[rng.random(2000) < 0.1, 2] = np.nan
    X[:4, 1] = [np.inf, -np.inf, 1e9, -1e9]
    mb = spec["max_bin"]
    # a sample smaller than the rows: occupancy still comes from all rows
    tm = tq.compute_bin_mapper(X, mb, 500, [1], seed=3)
    jm = jq.compute_bin_mapper(X, mb, 500, [1], seed=3)
    _assert_same_mapper(tm, jm)
    assert not tm.has_nan[1]
    np.testing.assert_array_equal(tq.apply_bins(tm, X, CPU).numpy(),
                                  np.asarray(jq.apply_bins(jm, X)))


def test_csr_binning_matches_the_reference_and_the_dense_bins():
    X, y = _data()
    Xs, csr = _csr(X)
    X[5, 2] = Xs[5, 2] = np.nan            # an explicit NaN in the CSR
    csr = sp.csr_matrix(Xs)
    assert np.isnan(csr.data).any()
    jm, jb = jdataset.bin_sparse(csr, None, 63, 1000, CATS, 2,
                                 chunk_rows=700)
    tm, tbins = tdataset.bin_sparse(csr, None, 63, 1000, CATS, 2,
                                    chunk_rows=700, device=CPU)
    _assert_same_mapper(tm, jm)
    # column 1's implicit zeros count in its bin 0
    assert tm.cat_counts[1] == len(np.unique(np.clip(np.nan_to_num(
        Xs[:, 1]), 0, 62).astype(int)))
    np.testing.assert_array_equal(tbins.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tbins.numpy(),
                                  tq.apply_bins(tm, Xs, CPU).numpy())
    # one chunk through the binner, and the one-shot wrapper
    rows = np.repeat(np.arange(N), np.diff(csr.indptr))
    one = tq.bin_csr_chunk(tm, csr.data, rows, csr.indices, N, device=CPU)
    np.testing.assert_array_equal(one.numpy(), tbins.numpy())
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jq.bin_csr_chunk(jm, csr.data, rows,
                                                 csr.indices, N)))
    ds = tdataset.Dataset(csr, y, categorical_features=CATS, max_bin=63,
                          bin_sample_count=1000, seed=2, device=CPU)
    jds = jdataset.Dataset(csr, y, categorical_features=CATS, max_bin=63,
                           bin_sample_count=1000, seed=2)
    np.testing.assert_array_equal(ds.binned.numpy(), np.asarray(jds.binned))
    np.testing.assert_array_equal(ds.raw_dense(), Xs)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

TREE_CASES = {
    "defaults": ("binary", {}),
    # the knobs, beside a monotone numeric column
    "knobs-monotone": ("binary", dict(cat_smooth=2.0, cat_l2=1.0,
                                      max_cat_threshold=4,
                                      min_data_per_group=60,
                                      max_cat_to_onehot=5,
                                      monotone_constraints=[0, 0, 0, 0, 1])),
    "multiclass-bagging": ("multiclass", dict(
        objective="multiclass", num_class=3, bagging_fraction=0.7,
        bagging_freq=1)),
}


def _same_trees(tb, jb):
    assert tb.num_trees == jb.num_trees
    for tt, jt in zip(tb.trees, jb.trees):
        ns = int(tt.num_splits)
        assert ns == int(jt.num_splits)
        for f in ("split_feature", "split_bin", "split_type", "default_left",
                  "left_child", "right_child", "cat_bitset"):
            np.testing.assert_array_equal(np.asarray(getattr(tt, f))[:ns],
                                          np.asarray(getattr(jt, f))[:ns],
                                          err_msg=f)
        np.testing.assert_allclose(np.asarray(tt.leaf_value)[:ns + 1],
                                   np.asarray(jt.leaf_value)[:ns + 1],
                                   rtol=LEAF_TOL, atol=LEAF_TOL)


def _popcounts(booster, feature: int) -> list:
    """The set sizes of every categorical split on ``feature``."""
    out = []
    for t in booster.trees:
        ns = int(t.num_splits)
        for i in range(ns):
            if t.split_type[i] == 1 and t.split_feature[i] == feature:
                out.append(int(sum(bin(int(w)).count("1")
                                   for w in t.cat_bitset[i])))
    return out


@pytest.fixture(scope="module")
def tree_fits():
    """{(case, policy): (X, y, cfg, JAX booster, port booster)}, fitted
    once."""
    out = {}
    for case, (kind, kw) in TREE_CASES.items():
        X, y = _data(kind=kind)
        for policy in POLICIES:
            cfg = dict(objective="binary", **BASE)
            cfg.update(kw, growth_policy=policy)
            jb = jboost.train_booster(X, y, jboost.BoosterConfig(**cfg),
                                      categorical_features=CATS,
                                      callbacks=[_host_loop])
            tb = tboost.train_booster(X, y, tboost.BoosterConfig(**cfg),
                                      categorical_features=CATS, device=CPU)
            out[case, policy] = (X, y, cfg, jb, tb)
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", list(TREE_CASES))
def test_categorical_fit_grows_the_reference_trees(tree_fits, case, policy):
    X, y, cfg, jb, tb = tree_fits[case, policy]
    _same_trees(tb, jb)
    np.testing.assert_allclose(tb.raw_score(X), np.asarray(jb.raw_score(X)),
                               rtol=LEAF_TOL, atol=LEAF_TOL)
    # both split modes ran: one-vs-rest on the 4-category column, and sets
    # of several categories on the 40-category one
    assert set(_popcounts(tb, 0)) == {1}
    assert max(_popcounts(tb, 1)) >= 2
    # no categorical split learns a NaN direction
    for t in tb.trees:
        ns = int(t.num_splits)
        assert not np.any(t.default_left[:ns] & (t.split_type[:ns] == 1))


@pytest.mark.parametrize("policy", POLICIES)
def test_csr_fit_grows_the_dense_fits_trees(tree_fits, policy):
    X, y, cfg, jb, tb = tree_fits["defaults", policy]
    got = tboost.train_booster(sp.csr_matrix(X), y,
                               tboost.BoosterConfig(**cfg),
                               categorical_features=CATS, device=CPU)
    _same_trees(got, jb)
    assert got.model_string() == tb.model_string()


def test_grow_tree_matches_the_reference_grower():
    """One tree of each policy from the growers themselves, on the same bins
    and gradients."""
    from synapseml_tpu.gbdt import grower as jgrower
    from synapseml_tpu_torch.gbdt import grower as tgrower
    import torch

    X, y = _data()
    mapper = tq.compute_bin_mapper(X, 255, 200_000, CATS)
    binned = tq.apply_bins(mapper, X, CPU)
    g = (0.5 - y).astype(np.float32)
    h = np.full(N, 0.25, np.float32)
    cat_nbins = np.where(mapper.is_categorical, mapper.cat_counts, 0x7FFF)
    for policy in POLICIES:
        kw = dict(num_leaves=15, min_data_in_leaf=10, min_data_per_group=30,
                  has_categorical=True, growth_policy=policy)
        jt, jnode = jgrower.grow_tree(
            jnp.asarray(binned.numpy()), jnp.asarray(g), jnp.asarray(h),
            jnp.ones(N), jnp.ones(5, bool),
            jnp.asarray(mapper.is_categorical), jnp.zeros(5, jnp.int32),
            jgrower.GrowerConfig(**kw),
            nan_bins=jnp.asarray(mapper.nan_bins),
            cat_nbins=jnp.asarray(cat_nbins))
        stats = {}
        tt, tnode = tgrower.grow_tree(
            binned, torch.as_tensor(g), torch.as_tensor(h), torch.ones(N),
            torch.ones(5, dtype=torch.bool), tgrower.GrowerConfig(**kw),
            nan_bins=mapper.nan_bins, stats=stats,
            is_categorical=mapper.is_categorical, cat_nbins=cat_nbins)
        tt = tgrower.tree_to_host(tt)
        ns = int(tt.num_splits)
        assert ns == int(jt.num_splits) and (tt.split_type[:ns] == 1).any()
        for f in ("split_feature", "split_bin", "split_type", "cat_bitset",
                  "left_child", "right_child"):
            np.testing.assert_array_equal(np.asarray(getattr(tt, f))[:ns],
                                          np.asarray(getattr(jt, f))[:ns])
        np.testing.assert_array_equal(tnode.numpy(),
                                      np.asarray(jnode)[:N])
        if policy == "leafwise":
            # a categorical tree costs what a numeric one does: one read
            # for the root and one per split
            assert stats["host_syncs"] == 1 + ns


# ---------------------------------------------------------------------------
# the independent oracle
# ---------------------------------------------------------------------------

ORACLE_CASES = {
    # test_gbdt_oracle.py TestCategoricalTrees: (data, knobs)
    "many-vs-many": (dict(seed=0, n=600, n_cat=2, cat_card=12),
                     dict(min_data_per_group=20, min_gain_to_split=0.05)),
    "capped-prefix": (dict(seed=5, n=800, n_cat=1, cat_card=16),
                      dict(min_data_per_group=15, max_cat_threshold=5,
                           min_gain_to_split=0.05)),
    "one-vs-rest": (dict(seed=1, n=500, n_cat=1, cat_card=4),
                    dict(min_data_per_group=20, min_gain_to_split=0.05)),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_categorical_tree_matches_the_oracle(case):
    import ml_dtypes

    from gbdt_oracle import OracleParams, oracle_grow_tree
    from test_gbdt_oracle import _make_data

    data, knobs = ORACLE_CASES[case]
    X, y, cats = _make_data(**data)
    ds = tdataset.Dataset(X, y, categorical_features=cats, max_bin=32,
                          seed=data["seed"], device=CPU)
    cfg = tboost.BoosterConfig(objective="binary", num_iterations=1,
                               learning_rate=1.0, max_bin=32, num_leaves=8,
                               min_data_in_leaf=20, **knobs)
    booster = tboost.train_booster(ds, None, cfg, device=CPU)
    p0 = np.clip(y.mean(), 1e-12, 1 - 1e-12)
    base = float(np.log(p0 / (1 - p0)))
    prob = 1.0 / (1.0 + np.exp(-base))
    grad = (prob - y).astype(ml_dtypes.bfloat16).astype(np.float64)
    hess = np.full(len(y), prob * (1 - prob)).astype(
        ml_dtypes.bfloat16).astype(np.float64)
    op = OracleParams(num_leaves=8, max_depth=0, min_data_in_leaf=20,
                      lambda_l1=0.0, lambda_l2=0.0,
                      min_gain_to_split=knobs["min_gain_to_split"],
                      monotone_constraints=None, cat_l2=cfg.cat_l2,
                      cat_smooth=cfg.cat_smooth,
                      min_data_per_group=cfg.min_data_per_group,
                      max_cat_to_onehot=cfg.max_cat_to_onehot,
                      max_cat_threshold=cfg.max_cat_threshold,
                      min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf)
    mapper, binned = ds.mapper, ds.binned.numpy()
    tree = oracle_grow_tree(binned, grad, hess, mapper.nan_bins,
                            mapper.is_categorical, mapper.cat_counts,
                            int(mapper.max_bin), op)
    want = base + tree.predict_raw(binned, mapper.nan_bins)
    np.testing.assert_allclose(booster.raw_score(X), want, rtol=0, atol=3e-5)
    assert int(booster.trees[0].num_splits) + 1 == len(tree.leaves)
    assert (np.asarray(booster.trees[0].split_type) == 1).any()


# ---------------------------------------------------------------------------
# what a categorical booster gives
# ---------------------------------------------------------------------------

def _carried(jb):
    arrays, config = booster_arrays(jb)
    return booster_from_reference(arrays, config, device=CPU)


@pytest.mark.parametrize("policy", POLICIES)
def test_model_string_dump_and_reload(tree_fits, policy):
    X, y, cfg, jb, tb = tree_fits["defaults", policy]
    text, want = tb.model_string(), jb.model_string()
    # the same trees; leaf values print 17 digits of float32 sums made in
    # another order, so only the head is compared byte for byte
    assert text.split("\ntree_sizes=")[0] == want.split("\ntree_sizes=")[0]
    assert "num_cat=" in text and "cat_threshold=" in text
    assert _carried(jb).model_string() == want
    assert _carried(jb).dump_model() == jb.dump_model()
    # categorical nodes dump their category set as "a||b"
    nodes = []

    def walk(nd):
        if "split_index" in nd:
            nodes.append(nd)
            walk(nd["left_child"])
            walk(nd["right_child"])

    for t in json.loads(tb.dump_model())["tree_info"]:
        walk(t["tree_structure"])
    cat_nodes = [nd for nd in nodes if nd["decision_type"] == "=="]
    assert any("||" in nd["threshold"] for nd in cat_nodes)
    jnodes = []
    for t in json.loads(jb.dump_model())["tree_info"]:
        nodes.clear()
        walk(t["tree_structure"])
        jnodes += [nd["threshold"] for nd in nodes
                   if nd["decision_type"] == "=="]
    assert [nd["threshold"] for nd in cat_nodes] == jnodes
    loaded = tboost.Booster.from_model_string(text, device=CPU)
    np.testing.assert_allclose(loaded.raw_score(X), tb.raw_score(X),
                               rtol=0, atol=1e-5)


def test_shap_of_categorical_splits_matches_the_reference(tree_fits):
    X, y, cfg, jb, tb = tree_fits["defaults", "leafwise"]
    Xs = X[:40]
    want = np.asarray(jb.feature_shap(Xs))
    got = _carried(jb).feature_shap(Xs)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    own = tb.feature_shap(sp.csr_matrix(Xs))
    np.testing.assert_allclose(own.sum(1), tb.raw_score(Xs), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("policy", POLICIES)
def test_csr_and_binned_scoring_equal_the_dense(tree_fits, policy):
    X, y, cfg, jb, tb = tree_fits["multiclass-bagging", policy]
    csr = sp.csr_matrix(np.nan_to_num(X[:500]))
    dense = np.nan_to_num(X[:500])
    np.testing.assert_array_equal(tb.predict(csr), tb.predict(dense))
    np.testing.assert_array_equal(tb.predict_leaf(csr),
                                  tb.predict_leaf(dense))
    np.testing.assert_array_equal(tb.raw_score(csr), tb.raw_score(dense))
    # rows binned with the booster's mapper: the reference's binned scores
    binned = tq.apply_bins(tb.mapper, X, CPU).numpy()
    np.testing.assert_allclose(
        tb.raw_score(binned, binned=True),
        np.asarray(jb.raw_score(jnp.asarray(binned), binned=True)),
        rtol=LEAF_TOL, atol=LEAF_TOL)
    # where a category is a plain id, bins and raw values route alike (a
    # NaN or negative id bins to 0, while raw traversal never counts it a
    # member: the JAX package's two traversals differ there too)
    plain = np.isfinite(X[:, 1]) & (X[:, 1] >= 0)
    np.testing.assert_allclose(tb.raw_score(binned[plain], binned=True),
                               tb.raw_score(X[plain]), rtol=0, atol=1e-6)


def test_categorical_validation_early_stops_as_the_reference():
    X, y = _data(seed=4)
    Xt, yt, valid = X[:2000], y[:2000], (sp.csr_matrix(X[2000:]), y[2000:])
    cfg = dict(objective="binary", num_iterations=30, num_leaves=15,
               min_data_in_leaf=10, min_data_per_group=30, learning_rate=0.8,
               early_stopping_round=2, metric="binary_logloss")
    jb = jboost.train_booster(Xt, yt, jboost.BoosterConfig(**cfg),
                              categorical_features=CATS,
                              valid=(X[2000:], y[2000:]))
    tb = tboost.train_booster(Xt, yt, tboost.BoosterConfig(**cfg),
                              categorical_features=CATS, valid=valid,
                              device=CPU)
    assert tb.best_iteration == jb.best_iteration
    assert tb.num_trees == jb.num_trees < 30
    assert abs(tb.best_score - jb.best_score) <= METRIC_TOL
    _same_trees(tb, jb)


# ---------------------------------------------------------------------------
# the estimators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("by", ["indexes", "names"])
def test_estimator_categorical_params_match_the_reference(by):
    X, y = _data(seed=6)
    names = [f"f{i}" for i in range(5)]
    cols = {n: X[:, i] for i, n in enumerate(names)}
    cols["label"] = y
    tt = assemble_features(Table(dict(cols)), names)
    jt = j_assemble(JTable(dict(cols)), names)
    params = dict(numIterations=4, numLeaves=15, minDataInLeaf=10,
                  minDataPerGroup=40, catSmooth=5.0, catl2=2.0,
                  maxCatThreshold=8, maxCatToOnehot=4)
    if by == "indexes":
        params["categoricalSlotIndexes"] = CATS
    else:
        params.update(categoricalSlotNames=["f0", "f1"], slotNames=names)
    tm = LightGBMClassifier(device=CPU, **params).fit(tt)
    jm = JClassifier(**params).fit(jt)
    _same_trees(tm.booster, jm.booster)
    assert any(np.asarray(t.split_type).any() for t in tm.booster.trees)
    np.testing.assert_allclose(tm.transform(tt)["probability"],
                               jm.transform(jt)["probability"], rtol=0,
                               atol=1e-6)
