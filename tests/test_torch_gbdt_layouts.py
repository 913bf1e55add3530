"""The leaf-wise grower's hot-loop designs against the JAX package's.

``tests/test_gbdt_engine.py``'s cases: every stable-partition primitive
(``partition_impl``), both other row layouts (``row_layout`` "gather" and
"masked") with NaN routing and with categorical data, and the unsegmented
window (``use_segmented=False``). Inputs are made with numpy from a seed
(or are ``tests/conftest.py``'s ``binary_data``) and go through both
packages; the port runs with ``device="cpu"`` (the plain histogram
versions). The mesh cases of the layouts are in
``tests/test_torch_gbdt_distributed.py``'s ``CASES``.

Tolerances. Primitives: the source indices exactly ``argsort(stable=True)``
's and the JAX package's. Trees: split features, bins, default directions,
categorical bitsets and the structure identical to the JAX fit with the
same knobs; leaf values within 1e-5 of it (float32 sums of two libraries)
and bitwise the port's own partition fit (every layout keeps a leaf's rows
in original row order, so every sum is the same).
"""

import itertools

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.gbdt import boosting as tboost
from synapseml_tpu_torch.gbdt import grower as tgrower
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
LEAF_ATOL = 1e-5
IMPLS = ("sort", "sort32", "scan", "scatter")
LAYOUTS = ("partition", "gather", "masked")
EXTRAS = ({"num_leaves": 15}, {"num_leaves": 31, "min_data_in_leaf": 5})


def _fields(t):
    ns = int(t.num_splits)
    out = {a: np.asarray(getattr(t, a))[:ns] for a in (
        "split_feature", "split_bin", "default_left", "left_child",
        "right_child", "split_type", "cat_bitset")}
    out["num_splits"] = ns
    out["leaf_value"] = np.asarray(t.leaf_value, np.float64)
    return out


def _assert_jax_trees(got, want):
    assert len(got.trees) == len(want.trees)
    for i, (a, b) in enumerate(zip(got.trees, want.trees)):
        fa, fb = _fields(a), _fields(b)
        for key in fa:
            if key == "leaf_value":
                np.testing.assert_allclose(fa[key], fb[key], rtol=0,
                                           atol=LEAF_ATOL,
                                           err_msg=f"tree {i}")
            else:
                np.testing.assert_array_equal(fa[key], fb[key],
                                              err_msg=f"tree {i} {key}")


def _assert_same_trees(got, want):
    for a, b in zip(got.trees, want.trees):
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)), f)


@pytest.fixture(scope="module")
def nan_data(binary_data):
    X, _, y, _ = binary_data
    X = np.array(X)
    X[::7, 3] = np.nan                   # the learned missing direction
    return X, y


def _cat_data():
    rng = np.random.default_rng(3)
    n = 2000
    cats = rng.integers(0, 10, size=n)
    y = np.isin(cats, [2, 5, 7]).astype(np.float32)
    X = np.stack([cats.astype(np.float32),
                  rng.normal(size=n).astype(np.float32)], 1)
    return X, y


def _cfg(pkg, **kw):
    return pkg.BoosterConfig(objective="binary", num_iterations=4, **kw)


@pytest.fixture(scope="module")
def jax_fits(nan_data):
    """The JAX package's fits, keyed like the port's cases."""
    from synapseml_tpu.gbdt import boosting as jboost

    X, y = nan_data
    out = {}
    for e, extra in enumerate(EXTRAS):
        for layout in LAYOUTS:
            out[("layout", e, layout)] = jboost.train_booster(
                X, y, _cfg(jboost, row_layout=layout, **extra))
    for impl in IMPLS[1:]:
        out[("impl", impl)] = jboost.train_booster(
            X, y, _cfg(jboost, partition_impl=impl, num_leaves=15))
    Xc, yc = _cat_data()
    for layout in LAYOUTS:
        out[("cat", layout)] = jboost.train_booster(
            Xc, yc, jboost.BoosterConfig(objective="binary",
                                         num_iterations=8,
                                         row_layout=layout),
            categorical_features=[0])
    return out


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4099])
def test_partition_primitive_is_stable_argsort(impl, n):
    import jax.numpy as jnp

    from synapseml_tpu.gbdt import grower as jgrower

    key = torch.as_tensor(np.random.default_rng(n).integers(-1, 3, size=n))
    src = tgrower.stable_partition_src(key, impl)
    assert torch.equal(src, torch.argsort(key, stable=True))
    want = np.asarray(jgrower._stable_partition_src(
        jnp.asarray(key.numpy(), jnp.int32), impl))
    np.testing.assert_array_equal(src.numpy(), want)


def test_unknown_impl_and_layout_are_refused(nan_data):
    X, y = nan_data
    with pytest.raises(ValueError, match="partition_impl"):
        tgrower.stable_partition_src(torch.zeros(4, dtype=torch.int64),
                                     "radix")
    with pytest.raises(ValueError, match="row_layout"):
        tboost.BoosterConfig(row_layout="rows")


@pytest.mark.parametrize("e", range(len(EXTRAS)))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_row_layout_is_the_jax_layouts(nan_data, jax_fits, layout, e):
    X, y = nan_data
    got = tboost.train_booster(X, y, _cfg(tboost, row_layout=layout,
                                          **EXTRAS[e]), device=CPU)
    _assert_jax_trees(got, jax_fits[("layout", e, layout)])
    _assert_jax_trees(got, jax_fits[("layout", e, "partition")])
    np.testing.assert_allclose(
        got.predict(X[:100]),
        jax_fits[("layout", e, layout)].predict(X[:100]), rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS[1:])
def test_partition_impl_is_the_jax_impls(nan_data, jax_fits, impl):
    X, y = nan_data
    got = tboost.train_booster(X, y, _cfg(tboost, partition_impl=impl,
                                          num_leaves=15), device=CPU)
    _assert_jax_trees(got, jax_fits[("impl", impl)])


@pytest.mark.parametrize(
    "layout,impl,segmented",
    list(itertools.product(LAYOUTS, IMPLS, (None, False))))
def test_every_combination_grows_the_partition_trees(nan_data, jax_fits,
                                                     layout, impl,
                                                     segmented):
    X, y = nan_data
    extra = EXTRAS[1]
    got = tboost.train_booster(X, y, _cfg(
        tboost, row_layout=layout, partition_impl=impl,
        use_segmented=segmented, **extra), device=CPU)
    want = tboost.train_booster(X, y, _cfg(tboost, **extra), device=CPU)
    _assert_same_trees(got, want)
    _assert_jax_trees(got, jax_fits[("layout", 1, "partition")])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_row_layout_categorical(jax_fits, layout):
    Xc, yc = _cat_data()
    got = tboost.train_booster(
        Xc, yc, tboost.BoosterConfig(objective="binary", num_iterations=8,
                                     row_layout=layout),
        categorical_features=[0], device=CPU)
    _assert_jax_trees(got, jax_fits[("cat", layout)])
    p = got.predict(Xc)
    assert ((p > 0.5) == (yc > 0.5)).mean() > 0.99


def test_host_reads_per_tree(nan_data):
    """Partition and masked read the device once per split (and once at
    the root); gather reads the smaller child's row count as well."""
    X, y = nan_data
    syncs = {}
    for layout in LAYOUTS:
        b = tboost.train_booster(X, y, _cfg(tboost, row_layout=layout,
                                            num_leaves=15), device=CPU)
        splits = sum(int(t.num_splits) for t in b.trees)
        syncs[layout] = (b.metadata["host_syncs"], splits, len(b.trees))
    for layout, (got, splits, trees) in syncs.items():
        per_split = 2 if layout == "gather" else 1
        assert got == trees + per_split * splits, layout


def test_scatter_refuses_other_layouts():
    cfg = tgrower.GrowerConfig(hist_reduce="scatter", feature_shards=2,
                               row_layout="masked")
    with pytest.raises(ValueError, match="partition row layout"):
        tgrower._check_reduce(cfg, object())
