"""The port's streamed GBDT against the JAX package's, on the same seeded
numpy inputs: ``StreamedDataset``'s boundaries, ``train_booster_streamed``'s
trees and model strings (both growth policies, bagging, GOSS, CSR chunks)
and ``Dataset.from_batches``'s bins and fits.

Tolerances, each with its reason:

* boundaries, bins, tree structure (split features, bins, gains' order,
  children, counts) and the leaf values of every tree: exact. On the CPU
  the port's chunk histograms are the plain ``index_add_`` over the
  chunk's rows in row order, as XLA's scatter adds them; the chunk
  partials sum in chunk order, as the JAX package's do; and the grower sums
  and scans over the bins in XLA's orders (``grower._bin_sum`` /
  ``_bin_cumsum``);
* the base score within 1e-6 relative: the objectives' init score is a
  float32 reduction over the rows in another order (the resident parity
  tests hold it so too). LightGBM folds the base score into the first
  tree's leaves, so the model strings are held line for line but for the
  float-sum lines (``SUMMED_FIELDS``), and a booster carried across by
  ``convert`` prints the JAX package's string byte for byte.
"""

import numpy as np
import pytest

from synapseml_tpu.gbdt import BoosterConfig as JConfig
from synapseml_tpu.gbdt import Dataset as JDataset
from synapseml_tpu.gbdt import StreamedDataset as JStreamed
from synapseml_tpu.gbdt import train_booster as jtrain
from synapseml_tpu.gbdt import train_booster_streamed as jstreamed

from synapseml_tpu_torch.convert import booster_arrays, booster_from_reference
from synapseml_tpu_torch.gbdt import BoosterConfig, Dataset, StreamedDataset
from synapseml_tpu_torch.gbdt import train_booster, train_booster_streamed
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
BASE_RTOL = 1e-6
# model-string lines printing float32 sums (or the trees' sizes in bytes)
SUMMED_FIELDS = ("tree_sizes=", "split_gain=", "leaf_value=", "leaf_weight=",
                 "internal_value=", "internal_weight=")
BASE = dict(objective="binary", num_iterations=5, num_leaves=8)


def _table(n=600, f=6, seed=0):
    """Features with missing values in one column, a label from an
    interaction plus noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.random(n) < 0.08, 3] = np.nan
    z = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] + 0.5 * rng.normal(size=n)
    return X, (z > 0).astype(np.float32)


def _same_mapper(got, want):
    assert got.boundaries.tobytes() == np.asarray(want.boundaries).tobytes()
    for field in ("num_bins", "nan_bins", "is_categorical"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))


def _same_booster(tb, jb):
    """Trees exact, base score within ``BASE_RTOL``, the model strings line
    for line but for the float-sum lines, the carried booster's string
    byte for byte."""
    assert len(tb.trees) == len(jb.trees)
    for tt, jt in zip(tb.trees, jb.trees):
        for field in tt._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(tt, field)),
                np.asarray(getattr(jt, field)), err_msg=field)
    np.testing.assert_allclose(tb.base_score, jb.base_score, rtol=BASE_RTOL)
    tlines, jlines = (b.model_string().splitlines() for b in (tb, jb))
    assert len(tlines) == len(jlines)
    assert [a for a in tlines if not a.startswith(SUMMED_FIELDS)] == \
        [b for b in jlines if not b.startswith(SUMMED_FIELDS)]
    arrays, config = booster_arrays(jb)
    carried = booster_from_reference(arrays, config, device=CPU)
    assert carried.model_string() == jb.model_string()


CASES = {
    "leafwise": {},
    "depthwise": dict(growth_policy="depthwise"),
    "bagging": dict(bagging_fraction=0.6, bagging_freq=2),
    "goss": dict(boosting_type="goss"),
    "features": dict(feature_fraction=0.6, feature_fraction_bynode=0.8),
    # past 256 bins the host chunks are uint16 (int16 on the way over)
    "wide_bins": dict(max_bin=300),
}


@pytest.fixture(scope="module")
def table():
    return _table()


@pytest.mark.parametrize("case", list(CASES))
def test_streamed_fit_is_the_jax_packages(table, case):
    X, y = table
    over = dict(BASE, **CASES[case])
    kw = dict(source_chunk=150, chunk_rows=128)
    tb = train_booster_streamed(StreamedDataset.from_arrays(X, y, **kw),
                                BoosterConfig(**over), device=CPU)
    jb = jstreamed(JStreamed.from_arrays(X, y, **kw), JConfig(**over))
    _same_booster(tb, jb)
    np.testing.assert_allclose(tb.predict(X), np.asarray(jb.predict(X)),
                               rtol=1e-6, atol=1e-7)


def test_csr_stream_is_the_jax_packages():
    sp = pytest.importorskip("scipy.sparse")
    X, y = _table(n=400, seed=2)
    X[np.random.default_rng(3).random(X.shape) < 0.6] = 0.0
    Xs = sp.csr_matrix(X)

    def batches():
        for i in range(0, 400, 90):
            yield Xs[i:i + 90], y[i:i + 90]

    over = dict(BASE, num_iterations=4)
    tds = StreamedDataset(batches, chunk_rows=64)
    jds = JStreamed(batches, chunk_rows=64)
    tb = train_booster_streamed(tds, BoosterConfig(**over), device=CPU)
    jb = jstreamed(jds, JConfig(**over))
    _same_mapper(tds.mapper, jds.mapper)
    _same_booster(tb, jb)


@pytest.mark.parametrize("over", [{}, dict(num_iterations=1, num_leaves=2)])
def test_default_second_pass_is_the_jax_packages(table, over):
    """Past the reservoir with no ``exact_second_pass`` given, the port
    decides the exact second sketch pass as the JAX package does (taken
    for BASE, skipped for a one-iteration stump), so the boundaries and
    the trees are the JAX package's. Before the port took the JAX rule it
    always skipped the pass, and a stream past 200,000 rows (the default
    reservoir) grew other trees than the JAX package's."""
    X, y = table
    over = dict(BASE, bin_sample_count=200, **over)
    tds = StreamedDataset.from_arrays(X, y, source_chunk=130, chunk_rows=128)
    jds = JStreamed.from_arrays(X, y, source_chunk=130, chunk_rows=128)
    tb = train_booster_streamed(tds, BoosterConfig(**over), device=CPU)
    jb = jstreamed(jds, JConfig(**over))
    assert tds.second_pass_decision["arm"] \
        == jds.second_pass_decision["arm"]
    assert tds.sketch_exact == jds.sketch_exact
    _same_mapper(tds.mapper, jds.mapper)
    _same_booster(tb, jb)


@pytest.mark.parametrize("cap", [10_000, 200])
def test_streamed_boundaries_are_the_jax_packages(table, cap):
    """The sketch pass in the exact regime and past the reservoir (no
    second pass on either side), and the cached chunks' bins."""
    X, y = table
    over = dict(BASE, bin_sample_count=cap)
    tds = StreamedDataset.from_arrays(X, y, source_chunk=130, chunk_rows=128,
                                      exact_second_pass=False)
    jds = JStreamed.from_arrays(X, y, source_chunk=130, chunk_rows=128,
                                exact_second_pass=False)
    tds.prepare(BoosterConfig(**over), device=CPU)
    jds.prepare(JConfig(**over))
    assert tds.sketch_exact == jds.sketch_exact == (cap > len(X))
    _same_mapper(tds.mapper, jds.mapper)
    assert len(tds.chunks) == len(jds.chunks)
    for i in range(len(tds.chunks)):
        np.testing.assert_array_equal(tds.chunk_bT(i),
                                      np.asarray(jds.chunk_bT(i)))
        for key in ("y", "w", "m"):
            np.testing.assert_array_equal(tds.chunks[i][key],
                                          jds.chunks[i][key])


@pytest.mark.parametrize("mapper", [False, True])
def test_from_batches_fit_is_the_jax_packages(table, mapper):
    """``Dataset.from_batches`` with the prefix-sample mapper (200 rows of
    600) or a mapper passed in: the same bins as the JAX package's, and
    ``train_booster`` on it gives its trees."""
    X, y = table

    def batches():
        for i in range(0, len(X), 70):
            yield X[i:i + 70], y[i:i + 70]

    kw = dict(max_bin=63, bin_sample_count=200, seed=3)
    m = None
    if mapper:
        from synapseml_tpu_torch.ops.quantize import compute_bin_mapper

        m = compute_bin_mapper(X, 63, 10_000, seed=3)
    tds = Dataset.from_batches(batches(), mapper=m, device=CPU, **kw)
    jds = JDataset.from_batches(batches(), mapper=m, **kw)
    _same_mapper(tds.mapper, jds.mapper)
    np.testing.assert_array_equal(tds.binned.numpy(), np.asarray(jds.binned))
    np.testing.assert_array_equal(tds.label, jds.label)
    over = dict(BASE, max_bin=63)
    tb = train_booster(tds, None, BoosterConfig(**over), device=CPU)
    jb = jtrain(jds, None, JConfig(**over))
    _same_booster(tb, jb)


def test_from_batches_refusals_are_the_jax_packages():
    X, y = _table(n=200, seed=4)
    X[:, 0] = np.where(np.arange(200) >= 150, np.nan, X[:, 0])
    X[:, 3] = np.nan_to_num(X[:, 3])

    def batches():
        for i in range(0, 200, 50):
            yield X[i:i + 50], y[i:i + 50]

    msgs = []
    for build in (lambda: Dataset.from_batches(batches(),
                                               bin_sample_count=100,
                                               device=CPU),
                  lambda: JDataset.from_batches(batches(),
                                                bin_sample_count=100)):
        with pytest.raises(ValueError, match="contain NaN") as e:
            build()
        msgs.append(str(e.value).split(" but ")[0])
    assert msgs[0] == msgs[1]
    for build in (lambda: Dataset.from_batches(iter([]), device=CPU),
                  lambda: JDataset.from_batches(iter([]))):
        with pytest.raises(ValueError, match="empty batch iterator"):
            build()
    with pytest.raises(ValueError, match="2-D"):
        Dataset.from_batches(iter([np.zeros(3, np.float32)]), device=CPU)
