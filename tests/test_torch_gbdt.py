"""The port's LightGBM classifier path against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``device="cpu"``, where every histogram goes through the
plain PyTorch version of its CUDA kernel. Tolerances, each with its reason:

* bins and tree structure: exact (same float32 boundaries, same searchsorted
  side; split decisions from histograms that agree to the last bits);
* grad/hess: 1e-6 relative (float32 sigmoid of two libraries);
* leaf values and predictions: 1e-5 relative/absolute (float32 sums taken in
  another order);
* a booster carried across as arrays: byte-identical model string and
  predictions within 1e-6 (same trees, traversal in another library).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.core import Table as JTable
from synapseml_tpu.core import assemble_features as j_assemble
from synapseml_tpu.gbdt import boosting as jboost
from synapseml_tpu.gbdt import grower as jgrower
from synapseml_tpu.gbdt import objectives as jobj
from synapseml_tpu.models import LightGBMClassifier as JClassifier
from synapseml_tpu.ops import quantize as jq

from synapseml_tpu_torch.convert import booster_arrays, booster_from_reference
from synapseml_tpu_torch.core import PipelineStage, Table, assemble_features
from synapseml_tpu_torch.core.device import resolve_device
from synapseml_tpu_torch.gbdt import boosting as tboost
from synapseml_tpu_torch.gbdt import grower as tgrower
from synapseml_tpu_torch.gbdt import objectives as tobj
from synapseml_tpu_torch.models import LightGBMClassifier
from synapseml_tpu_torch.ops import quantize as tq
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "synapseml_tpu_torch"
CPU = "cpu"
N, F = 4096, 28


def _higgs_like(n, f=F, seed=0, nan_cols=()):
    """Dense float32 features and a binary label with the margin of
    bench.py's HIGGS-shaped table; ``nan_cols`` get 10% missing values."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    margin = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] + 0.2 * rng.normal(size=n)
    for c in nan_cols:
        X[rng.random(n) < 0.1, c] = np.nan
    return X, (margin > 0).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _higgs_like(N, nan_cols=(3, 7))


@pytest.fixture(scope="module")
def jax_booster(data):
    X, y = data
    return jboost.train_booster(
        X, y, jboost.BoosterConfig(objective="binary", num_iterations=5))


def _tree_struct(t):
    ns = int(t.num_splits)
    return (ns, *(np.asarray(getattr(t, a))[:ns].tolist() for a in (
        "split_feature", "split_bin", "default_left", "left_child",
        "right_child")))


# ---------------------------------------------------------------------------
# binning, objective
# ---------------------------------------------------------------------------

def test_bins_equal_reference_with_nan_columns(data):
    X, _ = data
    jm = jq.compute_bin_mapper(X, 255)
    tm = tq.compute_bin_mapper(X, 255)
    for f in ("boundaries", "num_bins", "is_categorical", "has_nan"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    assert tm.has_nan[3] and tm.has_nan[7] and not tm.has_nan[0]
    want = np.asarray(jq.apply_bins(jm, X))
    got = tq.apply_bins(tm, X, device=CPU)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_binary_grad_hess_match_reference(data):
    _, y = data
    rng = np.random.default_rng(1)
    score = rng.normal(size=N).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    jg, jh = jobj.binary_objective().grad_hess(
        jnp.asarray(score), jnp.asarray(y), jnp.asarray(w))
    tg, th = tobj.binary_objective().grad_hess(
        torch.from_numpy(score), torch.from_numpy(y), torch.from_numpy(w))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6)
    # the base score is a logit near 0 here: the float32 label mean taken in
    # another order moves it by ~1e-6 absolute, far more in relative terms
    np.testing.assert_allclose(
        float(tobj.binary_objective().init_score(torch.from_numpy(y),
                                                 torch.from_numpy(w))),
        float(jobj.binary_objective().init_score(jnp.asarray(y),
                                                 jnp.asarray(w))),
        rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# grower
# ---------------------------------------------------------------------------

def test_one_tree_matches_reference(data):
    X, y = data
    mapper = jq.compute_bin_mapper(X, 255)
    binned = np.array(jq.apply_bins(mapper, X))     # writable for torch
    base = np.float32(0.1)
    p = 1 / (1 + np.exp(-base))
    g = (p - y).astype(np.float32)
    h = np.full(N, p * (1 - p), np.float32)
    in_bag = np.ones(N, np.float32)
    nan_bins = np.asarray(mapper.nan_bins, np.int32)
    jt, jnode = jgrower.grow_tree(
        jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(in_bag), jnp.ones(F, bool), jnp.zeros(F, bool),
        jnp.zeros(F, jnp.int32), jgrower.GrowerConfig(),
        nan_bins=jnp.asarray(nan_bins))
    tt, tnode = tgrower.grow_tree(
        torch.from_numpy(binned), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(in_bag), torch.ones(F, dtype=torch.bool),
        tgrower.GrowerConfig(), nan_bins=nan_bins)
    tt = tgrower.tree_to_host(tt)
    assert int(tt.num_splits) == 30
    assert _tree_struct(tt) == _tree_struct(jt)
    np.testing.assert_array_equal(tnode.numpy(), np.asarray(jnode))
    np.testing.assert_allclose(tt.leaf_value, np.asarray(jt.leaf_value),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tt.leaf_count, np.asarray(jt.leaf_count))
    np.testing.assert_allclose(tt.internal_value,
                               np.asarray(jt.internal_value), rtol=1e-5)
    np.testing.assert_allclose(tt.split_gain, np.asarray(jt.split_gain),
                               rtol=1e-4)


def test_grower_counts_host_syncs(data):
    X, y = data
    mapper = tq.compute_bin_mapper(X, 255)
    binned = tq.apply_bins(mapper, X, device=CPU)
    g = torch.from_numpy(0.5 - y)
    stats = {"host_syncs": 0}
    tree, _ = tgrower.grow_tree(binned, g, torch.full((N,), 0.25),
                                torch.ones(N), torch.ones(F, dtype=torch.bool),
                                tgrower.GrowerConfig(num_leaves=7),
                                nan_bins=mapper.nan_bins, stats=stats)
    assert stats["host_syncs"] == 1 + int(tree.num_splits) == 7


# ---------------------------------------------------------------------------
# boosting, model strings, weights carried across
# ---------------------------------------------------------------------------

def test_train_booster_matches_reference(data, jax_booster):
    X, y = data
    tb = tboost.train_booster(
        X, y, tboost.BoosterConfig(objective="binary", num_iterations=5),
        device=CPU)
    assert len(tb.trees) == len(jax_booster.trees) == 5
    for tt, jt in zip(tb.trees, jax_booster.trees):
        assert _tree_struct(tt) == _tree_struct(jt)
        np.testing.assert_allclose(tt.leaf_value, np.asarray(jt.leaf_value),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tb.base_score, jax_booster.base_score,
                               rtol=1e-6)
    np.testing.assert_allclose(tb.predict(X), jax_booster.predict(X),
                               rtol=1e-5, atol=1e-5)
    assert tb.metadata["host_syncs"] == sum(1 + int(t.num_splits)
                                            for t in tb.trees)


def test_booster_from_reference_is_byte_identical(data, jax_booster):
    X, _ = data
    arrays, config = booster_arrays(jax_booster)
    tb = booster_from_reference(arrays, config, device=CPU)
    assert tb.model_string() == jax_booster.model_string()
    np.testing.assert_allclose(tb.raw_score(X), jax_booster.raw_score(X),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.predict(X), jax_booster.predict(X),
                               rtol=1e-6, atol=1e-6)
    # and back through the port's own model-string parser
    loaded = tboost.Booster.from_model_string(tb.model_string(), device=CPU)
    np.testing.assert_allclose(loaded.predict(X), tb.predict(X), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError):
        booster_from_reference(arrays, dict(config, no_such_field=1),
                               device=CPU)


@pytest.fixture(scope="module")
def tables(data):
    """The same table in both packages, and the JAX classifier's output."""
    X, y = data
    cols = {f"f{i}": X[:, i] for i in range(F)}
    jt = j_assemble(JTable({**cols, "label": y}), list(cols))
    tt = assemble_features(Table({**cols, "label": y}), list(cols))
    return tt, JClassifier(numIterations=5).fit(jt).transform(jt)


def test_classifier_fit_transform_matches_reference(data, tables, tmp_path):
    X, _ = data
    tt, jout = tables
    model = LightGBMClassifier(numIterations=5, device=CPU).fit(tt)
    tout = model.transform(tt)
    np.testing.assert_allclose(tout["probability"], jout["probability"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tout["prediction"], jout["prediction"])
    # save/load and the native model string keep the predictions
    model.saveNativeModel(str(tmp_path / "model.txt"))
    loaded = tboost.Booster.from_model_string(
        (tmp_path / "model.txt").read_text(), device=CPU)
    np.testing.assert_allclose(loaded.predict(X), tout["probability"][:, 1],
                               rtol=1e-6, atol=1e-6)
    model.save(str(tmp_path / "stage"))
    again = PipelineStage.load(str(tmp_path / "stage")).transform(tt)
    np.testing.assert_allclose(again["probability"], tout["probability"],
                               rtol=1e-6, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_cuda_fit_matches_reference(data, tables, cuda):
    """The fit on the card, through both CUDA kernels, against the JAX
    package's. Atomics can flip a near-tie split, so the card is held to the
    cross-check tolerance of chip_smoke.py: AUC and mean absolute
    probability within 1e-3."""
    from synapseml_tpu_torch.ops import hist_kernel as thk

    _, y = data
    tt, jout = tables
    before = dict(thk.LAUNCHES)
    model = LightGBMClassifier(numIterations=5, device=cuda).fit(tt)
    launched = {k: thk.LAUNCHES[k] - before[k] for k in before}
    splits = sum(int(t.num_splits) for t in model.booster.trees)
    assert launched == {"child_histogram": 5, "range_histogram": splits,
                        "level_histograms": 0}
    tout = model.transform(tt)
    p, q = tout["probability"][:, 1], jout["probability"][:, 1]
    assert np.abs(p - q).mean() <= 1e-3
    auc_t = float(tobj.auc(torch.from_numpy(y), torch.from_numpy(p)))
    auc_j = float(tobj.auc(torch.from_numpy(y), torch.from_numpy(q)))
    assert abs(auc_t - auc_j) <= 1e-3


# ---------------------------------------------------------------------------
# what the slice rejects, and what the package may not depend on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("row_layout", "masked"), ("partition_impl", "scan"),
    ("use_segmented", False),
])
def test_train_booster_rejects_unported_config(data, field, value):
    """The engine knobs the port once refused by name now train, each the
    same trees as ``partition_impl="sort"`` with the partition layout
    (``tests/test_torch_gbdt_layouts.py`` holds every combination to the
    JAX package's trees)."""
    X, y = data
    base = tboost.BoosterConfig(objective="binary", num_iterations=2,
                                num_leaves=15)
    cfg = tboost.BoosterConfig(objective="binary", num_iterations=2,
                               num_leaves=15)
    setattr(cfg, field, value)
    want = tboost.train_booster(X[:1024], y[:1024], base, device=CPU)
    got = tboost.train_booster(X[:1024], y[:1024], cfg, device=CPU)
    assert [_tree_struct(t) for t in got.trees] \
        == [_tree_struct(t) for t in want.trees]
    for a, b in zip(got.trees, want.trees):
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


@pytest.mark.parametrize("field,value", [
    ("boosting_type", "dart"), ("boosting_type", "goss"),
    ("boosting_type", "rf"), ("bagging_fraction", 0.5),
    ("bagging_freq", 1), ("feature_fraction", 0.8),
    ("monotone_constraints", [1] + [0] * 27),
    ("feature_fraction_bynode", 0.5),
])
def test_train_booster_trains_the_sampling_it_once_refused(data, field,
                                                           value):
    """Each setting the port once refused by name now trains (rf with the
    bagging it requires); ``test_torch_gbdt_sampling.py`` holds the trees
    to the JAX package's."""
    X, y = data
    cfg = tboost.BoosterConfig(objective="binary", num_iterations=2,
                               num_leaves=7)
    setattr(cfg, field, value)
    if value == "rf":
        cfg.bagging_fraction, cfg.bagging_freq = 0.5, 1
    booster = tboost.train_booster(X[:256], y[:256], cfg, device=CPU)
    assert booster.num_trees == 2
    assert getattr(booster.config, field) == value
    assert np.isfinite(booster.raw_score(X[:256])).all()


@pytest.mark.parametrize("field,value", [("tree_learner", "voting")])
def test_train_booster_takes_the_learner_it_once_refused(data, field,
                                                         value):
    """Once refused by name: without a mesh the voting learner trains the
    JAX package's serial trees (the JAX package's own choice without a
    mesh), as the data learner does."""
    X, y = data
    kw = dict(objective="binary", num_iterations=2, num_leaves=7, top_k=3)
    got = tboost.train_booster(X[:512], y[:512], tboost.BoosterConfig(
        **kw, **{field: value}), device=CPU)
    want = jboost.train_booster(X[:512], y[:512], jboost.BoosterConfig(
        **kw, **{field: value}))
    assert [_tree_struct(t) for t in got.trees] \
        == [_tree_struct(t) for t in want.trees]
    assert got.config.tree_learner == value


@pytest.mark.parametrize("arg", ["mesh"])
def test_train_booster_takes_the_argument_it_once_refused(data, arg,
                                                          tmp_path):
    """A mesh once refused by name: on a world of one rank (gloo) its fit
    is the serial fit, model string for model string."""
    import torch.distributed as dist

    from synapseml_tpu_torch.parallel import init_distributed, make_mesh

    X, y = data
    cfg = dict(objective="binary", num_iterations=2, num_leaves=7)
    init_distributed("gloo", str(tmp_path / "store"), 0, 1)
    try:
        mesh = make_mesh({"data": 1}, device=CPU)
        got = tboost.train_booster(X[:257], y[:257],
                                   tboost.BoosterConfig(**cfg), device=CPU,
                                   **{arg: mesh})
    finally:
        dist.destroy_process_group()
    want = tboost.train_booster(X[:257], y[:257],
                                tboost.BoosterConfig(**cfg), device=CPU)
    assert got.model_string() == want.model_string()


@pytest.mark.parametrize("arg", ["early_stopping_round", "valid", "fobj",
                                 "init_model", "checkpoint_store"])
def test_train_booster_takes_what_it_once_refused(data, arg, tmp_path):
    X, y = data
    Xt, yt, valid = X[:512], y[:512], (X[512:768], y[512:768])
    cfg = tboost.BoosterConfig(objective="binary", num_iterations=3,
                               num_leaves=7)
    kw = {}
    if arg == "early_stopping_round":
        cfg.early_stopping_round, cfg.learning_rate = 1, 1.0
        kw["valid"] = valid
    elif arg == "valid":
        kw["valid"] = valid
    elif arg == "fobj":
        def logistic(score, label, weight):
            p = torch.sigmoid(score)
            return (p - label) * weight, p * (1 - p) * weight
        kw["fobj"] = logistic
    elif arg == "init_model":
        kw["init_model"] = tboost.train_booster(Xt, yt, cfg, device=CPU)
    else:
        kw.update(checkpoint_store=str(tmp_path), checkpoint_every=1)
    booster = tboost.train_booster(Xt, yt, cfg, device=CPU, **kw)
    if arg == "early_stopping_round":
        assert booster.num_trees == booster.best_iteration + 1
    elif arg == "valid":
        assert booster.best_iteration >= 0 and booster.best_score > 0.5
    elif arg == "fobj":
        plain = tboost.train_booster(Xt, yt, cfg, device=CPU)
        assert [_tree_struct(t) for t in booster.trees] \
            == [_tree_struct(t) for t in plain.trees]
    elif arg == "init_model":
        assert booster.num_trees == 6
    else:
        from synapseml_tpu_torch.core.checkpoint import CheckpointStore
        assert CheckpointStore(str(tmp_path)).latest_step() == 3


def test_classifier_rejects_unported_params(data):
    """Every param of the JAX estimator is ported (``topK`` and
    ``parallelism`` once were refused: without a mesh they train the JAX
    package's serial trees, as ``tree_learner=voting`` through
    ``passThroughArgs`` does); ``row_layout=masked`` through
    ``passThroughArgs`` takes effect and grows the partition layout's
    trees."""
    X, y = data
    jparams = set(JClassifier()._params)
    tparams = set(LightGBMClassifier(device=CPU)._params)
    from synapseml_tpu_torch.models.gbdt import UNPORTED_PARAMS
    assert jparams - tparams == set(UNPORTED_PARAMS) == set()
    cols = {"a": X[:256, 0], "b": X[:256, 1], "c": X[:256, 2],
            "label": y[:256]}
    t = assemble_features(Table(cols), ["a", "b", "c"])
    jt = j_assemble(JTable(cols), ["a", "b", "c"])
    for params in ({"topK": 1}, {"parallelism": "voting_parallel",
                                 "topK": 1},
                   {"passThroughArgs": "tree_learner=voting"}):
        kw = dict(numIterations=2, numLeaves=5, **params)
        got = LightGBMClassifier(device=CPU, **kw).fit(t)
        want = JClassifier(**kw).fit(jt)
        assert [_tree_struct(b) for b in got.booster.trees] \
            == [_tree_struct(b) for b in want.booster.trees], params
        est = LightGBMClassifier(device=CPU).set("topK", 10)
        assert est.getTopK() == 10
    kw = dict(numIterations=2, numLeaves=5)
    masked = LightGBMClassifier(device=CPU, passThroughArgs="row_layout=masked",
                                **kw).fit(t)
    assert masked.booster.config.row_layout == "masked"
    plain = LightGBMClassifier(device=CPU, **kw).fit(t)
    assert [_tree_struct(b) for b in masked.booster.trees] \
        == [_tree_struct(b) for b in plain.booster.trees]


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        tboost.train_booster(np.zeros((8, 2), np.float32),
                             np.arange(8) % 2,
                             tboost.BoosterConfig(objective="binary"))
    t = assemble_features(Table({"a": np.arange(8.0),
                                 "label": np.arange(8) % 2}), ["a"])
    with pytest.raises(RuntimeError, match="cuda"):
        LightGBMClassifier(numIterations=1).fit(t)
    assert resolve_device("cpu") == torch.device("cpu")


def test_import_leaves_jax_out():
    code = ("import sys, synapseml_tpu_torch, synapseml_tpu_torch.models, "
            "synapseml_tpu_torch.convert, synapseml_tpu_torch.ops._build, "
            "synapseml_tpu_torch.parallel, synapseml_tpu_torch.dl, "
            "synapseml_tpu_torch.ops.attention_kernel, "
            "synapseml_tpu_torch.core.inference, "
            "synapseml_tpu_torch.io.serving, "
            "synapseml_tpu_torch.io.serving_main, "
            "synapseml_tpu_torch.io.ingest, synapseml_tpu_torch.gbdt.stream, "
            "synapseml_tpu_torch.onnx, synapseml_tpu_torch.onnx.treeensemble, "
            "synapseml_tpu_torch.io.distributed_serving, "
            "synapseml_tpu_torch.core.gossip, synapseml_tpu_torch.testing, "
            "synapseml_tpu_torch.vw, synapseml_tpu_torch.online, "
            "synapseml_tpu_torch.isolationforest, synapseml_tpu_torch.cyber, "
            "synapseml_tpu_torch.recommendation, synapseml_tpu_torch.nn, "
            "synapseml_tpu_torch.explainers, synapseml_tpu_torch.causal, "
            "synapseml_tpu_torch.image, synapseml_tpu_torch.ops.histogram, "
            "synapseml_tpu_torch.ops.image, synapseml_tpu_torch.featurize, "
            "synapseml_tpu_torch.stages, synapseml_tpu_torch.train, "
            "synapseml_tpu_torch.exploratory, synapseml_tpu_torch.automl, "
            "synapseml_tpu_torch.automl.worker, synapseml_tpu_torch.native; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'synapseml_tpu' or m.startswith("
            "'synapseml_tpu.')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_prints_no_result_without_a_card_or_the_package(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout


def test_sources_do_not_name_jax_or_the_jax_package():
    offenders = []
    for path in sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        text = path.read_text()
        if "import jax" in text or "from jax" in text \
                or "synapseml_tpu." in text or "import synapseml_tpu\n" in text:
            offenders.append(str(path.relative_to(REPO)))
    assert offenders == []
