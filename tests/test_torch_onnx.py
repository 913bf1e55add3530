"""The port's ONNX package against the JAX package's, on the CPU.

* the protobuf reader and writer: the same bytes both ways;
* every committed fixture (``tests/resources/onnx``, written by torch's own
  exporter with torch's eval output beside it): the port against torch's
  output (rtol 2e-3 / atol 2e-4, ``tests/test_onnx_thirdparty.py:65``) and
  against the JAX ``OnnxFunction`` on the same bytes (1e-4 / 1e-4);
* control flow: the folded If/Loop forms and the runtime If/Loop/Scan
  forms, on the graphs ``tests/test_onnx_control_flow.py`` builds, against
  the JAX package under ``jax.jit`` (its ``ONNXModel`` path: a runtime
  loop's scan outputs padded to ``max_loop_trips``);
* ``ONNXModel`` (mini-batches with a padded tail, slicing, post-transforms,
  persistence), ``ImageFeaturizer``, ``ONNXHub`` over a temporary cache and
  ``Booster.to_onnx`` (bytes identical to the JAX package's for a booster
  carried across by ``convert``; scores equal to ``predict`` within 2e-4 /
  2e-5, ``tests/test_onnx_treeensemble.py:48``).
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_onnx as jtest_onnx
import test_onnx_control_flow as jcf
from synapseml_tpu.core.table import Table as JTable
from synapseml_tpu.gbdt import boosting as jboost
from synapseml_tpu.onnx import ImageFeaturizer as JImageFeaturizer
from synapseml_tpu.onnx import Model as JModel
from synapseml_tpu.onnx import ONNXModel as JONNXModel
from synapseml_tpu.onnx import OnnxFunction as JOnnxFunction
from synapseml_tpu.onnx.treeensemble import booster_to_onnx as j_to_onnx
from synapseml_tpu.ops import image as jimage

from synapseml_tpu_torch.convert import booster_arrays, booster_from_reference
from synapseml_tpu_torch.core import PipelineStage, Table
from synapseml_tpu_torch.onnx import (ImageFeaturizer, Model, ONNXHub,
                                      ONNXModel, OnnxFunction, fold_constants,
                                      import_model)
from synapseml_tpu_torch.ops import image as timage
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
RES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "resources",
                   "onnx")
FIXTURES = sorted(f[:-5] for f in os.listdir(RES) if f.endswith(".onnx"))
TORCH_RTOL, TORCH_ATOL = 2e-3, 2e-4      # the JAX package's fixture bound
RTOL = ATOL = 1e-4                       # port against the JAX package
TREE_RTOL, TREE_ATOL = 2e-4, 2e-5        # ONNX graph against predict


def _fixture(name):
    with open(os.path.join(RES, f"{name}.onnx"), "rb") as f:
        raw = f.read()
    return raw, np.load(os.path.join(RES, f"{name}.npz"))


def _jax_jit(raw, feeds, **kw):
    """The JAX package's function on ``feeds`` under ``jax.jit``."""
    fn = JOnnxFunction(JModel.parse(raw), **kw)
    f, names = fn.as_jax(list(feeds))
    out = jax.jit(f)(*[jnp.asarray(feeds[n]) for n in names])
    return dict(zip(fn.outputs, (np.asarray(o) for o in out)))


def _port(raw, feeds, card_branch=False, **kw):
    """The port's function on the CPU; ``card_branch`` makes it run control
    flow as on the card (device conditions never read mid-call)."""
    fn = OnnxFunction(Model.parse(raw), device=CPU, **kw)
    fn._on_card = card_branch
    return {k: v.numpy() for k, v in fn(feeds).items()}


# ---------------------------------------------------------------------------
# protobuf reader and writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_protobuf_reader_and_writer_match_the_reference(name):
    """Each package parses torch's bytes and writes them back: the same
    bytes, and the same decoded weights."""
    raw, _ = _fixture(name)
    tm, jm = Model.parse(raw), JModel.parse(raw)
    assert tm.encode() == jm.encode()
    assert tm.producer_name == jm.producer_name and "pytorch" in \
        tm.producer_name.lower()
    for k, t in jm.graph.initializers.items():
        np.testing.assert_array_equal(tm.graph.initializers[k].array(),
                                      t.array())
    model, _ = jtest_onnx._mlp_model(np.random.default_rng(0))
    assert Model.parse(model.encode()).encode() == model.encode()


# ---------------------------------------------------------------------------
# committed fixtures: torch's output and the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_torch_and_the_reference(name):
    raw, data = _fixture(name)
    fn = OnnxFunction(Model.parse(raw), device=CPU)
    got = fn({fn.graph_inputs[0]: data["x"]})[fn.outputs[0]].numpy()
    np.testing.assert_allclose(got, data["y"], rtol=TORCH_RTOL,
                               atol=TORCH_ATOL)
    jfn = JOnnxFunction(JModel.parse(raw))
    want = np.asarray(jfn({jfn.graph_inputs[0]: data["x"]})[jfn.outputs[0]])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_dynamic_control_flow_fixtures_through_onnx_model():
    """Every fixture through ``ONNXModel`` (constant folding first) in one
    mini-batch (the runtime If and Loop fixtures' conditions aggregate over
    the whole input), as ``tests/test_onnx_thirdparty.py`` runs them; the
    Loop's condition is computed on the device, so the port runs it under
    the device mask. The folded BERT fixture keeps its (2, 2) output (the
    JAX package's fold turns a 0-d Gather index into shape (1,))."""
    for name in FIXTURES:
        raw, data = _fixture(name)
        m = Model.parse(raw)
        in_name = [vi.name for vi in m.graph.inputs
                   if vi.name not in m.graph.initializers][0]
        model = (ONNXModel(device=CPU).setModelPayload(raw)
                 .setFeedDict({in_name: "features"})
                 .setFetchDict({"out": m.graph.outputs[0].name})
                 .setMiniBatchSize(64))
        out = model.transform(Table({"features": data["x"]}))
        np.testing.assert_allclose(out["out"], data["y"], rtol=TORCH_RTOL,
                                   atol=TORCH_ATOL)


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------

def _data_if(then_g, else_g):
    n = jcf.Node(op_type="Greater", inputs=["x", "zero"], outputs=["gt"])
    red = jcf.Node(op_type="ReduceMax", inputs=["gt"], outputs=["cond"],
                   attrs={"keepdims": jcf._attr("keepdims", 0)})
    m = jcf._if_model(True, then_g, else_g, extra_nodes=[n, red],
                      extra_inits={"zero": jcf.Tensor.from_array(
                          "zero", np.float32(0))})
    del m.graph.initializers["cond"]
    return m


def _loop(trips, n_scan, fed_trips=False):
    m = jcf.TestConstantLoop()._loop_model(trips=trips, n_scan=n_scan)
    if fed_trips:
        del m.graph.initializers["M"]
        m.graph.inputs.append(jcf._vi("M", []))
    return m


def _while_loop(n_scan, fed_cond=False):
    """cond computed in the body from the carried value (c < 5, c += x):
    a condition that lives on the device; ``fed_cond`` makes the first
    condition a graph input."""
    body_nodes = [
        jcf.Node(op_type="Add", inputs=["c_in", "x"], outputs=["c_out"]),
        jcf.Node(op_type="ReduceMax", inputs=["c_out"], outputs=["cmax"],
                 attrs={"keepdims": jcf._attr("keepdims", 0)}),
        jcf.Node(op_type="Less", inputs=["cmax", "limit"],
                 outputs=["cond_out"])]
    outs = [jcf._vi("cond_out", []), jcf._vi("c_out", [2])]
    loop_outs = ["c_final"]
    if n_scan:
        body_nodes.append(jcf.Node(op_type="Mul", inputs=["c_out", "c_out"],
                                   outputs=["sq"]))
        outs.append(jcf._vi("sq", [2]))
        loop_outs.append("stacked")
    body = jcf.Graph(nodes=body_nodes, initializers={
        "limit": jcf.Tensor.from_array("limit", np.float32(5.0))},
        inputs=[jcf._vi("iter", []), jcf._vi("cond_in", []),
                jcf._vi("c_in", [2])], outputs=outs, name="body")
    loop = jcf.Node(op_type="Loop", inputs=["", "lcond", "c0"],
                    outputs=loop_outs, name="while_loop",
                    attrs={"body": jcf.Attribute(name="body", type=5,
                                                 g=body)})
    inits = {"c0": jcf.Tensor.from_array("c0", np.zeros(2, np.float32))}
    inputs = [jcf._vi("x", [2])]
    if fed_cond:
        inputs.append(jtest_onnx.ValueInfo(name="lcond", elem_type=9, shape=[]))
    else:
        inits["lcond"] = jcf.Tensor.from_array("lcond", np.asarray(True))
    return jcf.Model(graph=jcf.Graph(
        nodes=[loop], initializers=inits, inputs=inputs,
        outputs=[jcf._vi(o, [2]) for o in loop_outs], name="g"), opset=17)


_X2 = np.asarray([1.5, 2.0], np.float32)
CONTROL_FLOW = {
    "if-constant-then": (lambda: jcf._if_model(True, jcf._branch(3.0),
                                               jcf._branch(5.0)), {}),
    "if-constant-else": (lambda: jcf._if_model(False, jcf._branch(3.0),
                                               jcf._branch(5.0)), {}),
    "if-runtime-positive": (lambda: _data_if(jcf._branch(3.0),
                                             jcf._branch(5.0)), {}),
    "if-runtime-negative": (lambda: _data_if(jcf._branch(3.0),
                                             jcf._branch(5.0)),
                            {"x": -_X2}),
    "loop-unrolled-scan": (lambda: _loop(4, 1), {}),
    "loop-unrolled-carry": (lambda: _loop(3, 0), {}),
    "loop-fed-trips": (lambda: _loop(2, 0, True),
                       {"M": np.asarray(5, np.int64)}),
    "loop-fed-trips-scan": (lambda: _loop(2, 1, True),
                            {"M": np.asarray(4, np.int64)}),
    "loop-while-carry": (lambda: _while_loop(0), {}),
    "loop-while-scan": (lambda: _while_loop(1), {}),
    "loop-while-scan-no-trip": (lambda: _while_loop(1, fed_cond=True),
                                {"lcond": np.asarray(False)}),
    "loop-while-scan-fed-cond": (lambda: _while_loop(1, fed_cond=True),
                                 {"lcond": np.asarray(True)}),
    "scan-forward": (lambda: jcf.TestScan()._scan_model(),
                     {"xs": np.arange(8, dtype=np.float32).reshape(4, 2)}),
    "scan-reverse": (lambda: jcf.TestScan()._scan_model(reverse=True),
                     {"xs": np.arange(8, dtype=np.float32).reshape(4, 2)}),
}


@pytest.mark.parametrize("card_branch", [False, True])
@pytest.mark.parametrize("cid", sorted(CONTROL_FLOW))
def test_control_flow_matches_the_reference_under_jit(cid, card_branch):
    build, feeds = CONTROL_FLOW[cid]
    raw = build().encode()
    feeds = dict(feeds)
    if not ("xs" in feeds or "x" in feeds):
        feeds["x"] = _X2
    kw = dict(max_loop_trips=6)
    want = _jax_jit(raw, {k: (v.astype(np.int32) if k == "M" else v)
                          for k, v in feeds.items()}, **kw)
    got = _port(raw, feeds, card_branch, **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, (k, got[k].shape)
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


def test_control_flow_refusals_name_themselves():
    """Branches of different shapes, a loop that would be truncated and a
    malformed If raise as the JAX package raises."""
    then_g = jcf.Graph(nodes=[jcf.Node(op_type="Concat", inputs=["x", "x"],
                                       outputs=["wide"],
                                       attrs={"axis": jcf._attr("axis", 0)})],
                       initializers={}, inputs=[],
                       outputs=[jcf._vi("wide", [4])], name="tb")
    fn = OnnxFunction(_data_if(then_g, jcf._branch(5.0)), device=CPU)
    with pytest.raises(ValueError, match="matching shapes"):
        fn({"x": _X2})
    raw = _while_loop(1).encode()
    with pytest.raises(ValueError, match="max_loop_trips"):
        _port(raw, {"x": np.full(2, 0.01, np.float32)}, max_loop_trips=4)
    fn = OnnxFunction(Model.parse(_loop(2, 0, True).encode()), device=CPU,
                      max_loop_trips=4)
    fn._on_card = True
    with pytest.raises(ValueError, match="max_loop_trips=4"):
        fn({"x": _X2, "M": np.asarray(5, np.int64)})


@pytest.mark.parametrize("n_scan", [0, 1])
def test_a_loop_cut_at_its_bound_on_the_card_raises(n_scan):
    """On the card a Loop whose condition lives on the device runs
    ``max_loop_trips`` trips under a mask. Past the bound with the condition
    still true, the eager call and ``ONNXModel``'s captured path (the flag
    read after the copy-out) raise; a loop that ended inside the bound gives
    the CPU's answer."""
    raw = _while_loop(n_scan).encode()
    slow = np.full(2, 0.01, np.float32)
    with pytest.raises(ValueError, match="max_loop_trips=4"):
        _port(raw, {"x": slow}, card_branch=True, max_loop_trips=4)
    model = (ONNXModel(device=CPU).setModelPayload(raw)
             .setFeedDict({"x": "x"}).setFetchDict({"c": "c_final"})
             .set("maxLoopTrips", 4).setMiniBatchSize(2))
    model._onnx_fn()._on_card = True
    with pytest.raises(ValueError, match="max_loop_trips=4"):
        model.transform(Table({"x": slow}))
    fast = {"x": np.full(2, 2.0, np.float32)}
    want = _port(raw, fast, max_loop_trips=4)
    got = _port(raw, fast, card_branch=True, max_loop_trips=4)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    m = jcf._if_model(True, jcf._branch(3.0), jcf._branch(5.0))
    m.graph.nodes[-1].outputs = ["y", "z"]
    m.graph.outputs.append(jcf._vi("z", [2]))
    with pytest.raises(ValueError, match="declares 1 outputs"):
        OnnxFunction(Model.parse(m.encode()), device=CPU)


def test_folding_slicing_and_refusals():
    model, (W1, b1, _) = jtest_onnx._mlp_model(np.random.default_rng(2))
    fn = import_model(model.encode(), outputs=["hidden"], device=CPU)
    assert [n.name for n in fn._plan] == ["fc1", "relu"]
    x = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_allclose(fn({"x": x})["hidden"].numpy(),
                               np.maximum(x @ W1 + b1, 0), rtol=1e-5)
    with pytest.raises(ValueError, match="missing input"):
        fn({})
    g = jtest_onnx.Graph(nodes=[jtest_onnx.Node(op_type="FancyOp",
                                                inputs=["x"], outputs=["y"])],
                         inputs=[jtest_onnx._vi("x", [2])],
                         outputs=[jtest_onnx._vi("y", [2])])
    with pytest.raises(NotImplementedError, match="FancyOp"):
        import_model(jtest_onnx.Model(graph=g).encode(), device=CPU)(
            {"x": np.zeros(2, np.float32)})
    # constant folding leaves the one data-dependent node, as in JAX
    m = Model.parse(jtest_onnx.Model(graph=jtest_onnx.Graph(
        nodes=[jtest_onnx.Node(op_type="Constant", outputs=["two"], attrs={
            "value": jtest_onnx.Attribute(
                name="value", type=4, t=jtest_onnx.Tensor.from_array(
                    "", np.asarray([2.0], np.float32)))}),
            jtest_onnx.Node(op_type="Mul", inputs=["two", "three"],
                            outputs=["six"]),
            jtest_onnx.Node(op_type="Mul", inputs=["x", "six"],
                            outputs=["y"])],
        initializers={"three": jtest_onnx.Tensor.from_array(
            "three", np.asarray([3.0], np.float32))},
        inputs=[jtest_onnx._vi("x", ["N"])],
        outputs=[jtest_onnx._vi("y", ["N"])])).encode())
    folded = fold_constants(m)
    assert len(folded.graph.nodes) == 1
    np.testing.assert_allclose(OnnxFunction(folded, device=CPU)(
        {"x": np.asarray([1.0, 2.0], np.float32)})["y"].numpy(), [6.0, 12.0])


def test_entry_points_default_to_the_card():
    raw, _ = _fixture("torch_mlp")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        OnnxFunction(Model.parse(raw))
    with pytest.raises(RuntimeError, match="cuda"):
        ONNXModel().setModelPayload(raw).modelOutput()


# ---------------------------------------------------------------------------
# ONNXModel
# ---------------------------------------------------------------------------

def _mlp_stages(**params):
    model, weights = jtest_onnx._mlp_model(np.random.default_rng(5))
    raw = model.encode()
    stages = []
    for cls, kw in ((ONNXModel, dict(device=CPU)), (JONNXModel, {})):
        m = cls(miniBatchSize=4, **kw).setModelPayload(raw)
        for k, v in params.items():
            m.set(k, v)
        stages.append(m)
    return stages, weights


def test_onnx_model_transform_matches_the_reference():
    """10 rows at miniBatchSize 4: two full batches and a padded tail;
    softmax and argmax post-transforms; the same columns as JAX's."""
    (tm, jm), (W1, b1, W2) = _mlp_stages(
        feedDict={"x": "features"}, fetchDict={"rawPrediction": "out",
                                               "hidden": "hidden"},
        softMaxDict={"rawPrediction": "probability"},
        argMaxDict={"rawPrediction": "prediction"})
    X = np.random.default_rng(6).normal(size=(10, 4)).astype(np.float32)
    got = tm.transform(Table({"features": X}))
    want = jm.transform(JTable({"features": X}))
    assert got.columns == want.columns
    for col in ("rawPrediction", "hidden", "probability"):
        np.testing.assert_allclose(got[col], np.asarray(want[col]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["rawPrediction"],
                               np.maximum(X @ W1 + b1, 0) @ W2, rtol=1e-4,
                               atol=1e-5)
    runner = next(iter(tm._runner_cache.values()))
    assert runner.stats()["compiles"] == {2: 1, 4: 1}
    assert tm.modelInput() == jm.modelInput()
    assert tm.modelOutput() == jm.modelOutput()
    plain = tm.copy().set("softMaxDict", None).set("argMaxDict", None)
    empty = plain.transform(Table({"features": X[:0]}))
    assert empty["rawPrediction"].shape == (0,)


def test_onnx_model_slicing_persistence_and_precision(tmp_path):
    (tm, _), (W1, b1, _) = _mlp_stages(feedDict={"x": "features"},
                                       fetchDict={"out": "out"})
    X = np.random.default_rng(8).normal(size=(4, 4)).astype(np.float32)
    sliced = tm.sliceAtOutput("hidden")
    np.testing.assert_allclose(
        sliced.transform(Table({"features": X}))["hidden"],
        np.maximum(X @ W1 + b1, 0), rtol=1e-4, atol=1e-6)
    expected = tm.transform(Table({"features": X}))["out"]
    p = str(tmp_path / "onnx_model")
    tm.save(p)
    loaded = PipelineStage.load(p)
    assert loaded.getDevice() == CPU
    np.testing.assert_array_equal(
        loaded.transform(Table({"features": X}))["out"], expected)
    tm.set("floatPrecision", "bfloat16")     # any setter route rebuilds
    assert tm._onnx_fn().precision == "bfloat16"
    bf = tm.transform(Table({"features": X}))["out"]
    assert bf.dtype == np.float32
    np.testing.assert_allclose(bf, expected, rtol=0.05, atol=0.05)


# ---------------------------------------------------------------------------
# ImageFeaturizer, image helpers, hub
# ---------------------------------------------------------------------------

def test_image_helpers_match_the_reference():
    imgs = np.random.default_rng(1).uniform(0, 255, (2, 5, 7, 3)).astype(
        np.float32)
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]
    np.testing.assert_allclose(
        timage.normalize(imgs, mean, std, scale=1 / 255.0),
        np.asarray(jimage.normalize(imgs, mean, std, scale=1 / 255.0)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(timage.to_chw(imgs),
                                  np.asarray(jimage.to_chw(imgs)))


@pytest.mark.parametrize("headless", [True, False])
def test_image_featurizer_matches_the_reference(headless):
    """The convnet fixture, images resized 12x10 -> 16x16, headless (the
    input of the last Gemm, found by the same rule) or its logits."""
    raw, _ = _fixture("torch_convnet")
    rng = np.random.default_rng(9)
    imgs = np.empty(3, object)
    for i in range(3):
        imgs[i] = rng.uniform(0, 255, size=(12, 10, 3)).astype(np.float32)
    kw = dict(inputCol="image", outputCol="features", imageHeight=16,
              imageWidth=16, headless=headless)
    got = (ImageFeaturizer(**kw).setModel(
        ONNXModel(device=CPU, miniBatchSize=2).setModelPayload(raw))
        .transform(Table({"image": imgs}))["features"])
    want = (JImageFeaturizer(**kw).setModel(
        JONNXModel(miniBatchSize=2).setModelPayload(raw))
        .transform(JTable({"image": imgs}))["features"])
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_hub_reads_a_local_cache(tmp_path):
    raw, _ = _fixture("torch_mlp")
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "mlp.onnx").write_bytes(raw)
    manifest = [{"model": "TinyMLP", "model_path": "m/mlp.onnx",
                 "opset_version": 14,
                 "metadata": {"model_sha": hashlib.sha256(raw).hexdigest(),
                              "tags": ["demo"]}},
                {"model": "TinyMLP", "model_path": "m/old.onnx",
                 "opset_version": 9, "metadata": {}}]
    (tmp_path / "ONNX_HUB_MANIFEST.json").write_text(json.dumps(manifest))
    hub = ONNXHub(str(tmp_path))
    assert [i.model for i in hub.list_models(tags=["demo"])] == ["TinyMLP"]
    assert hub.get_model_info("tinymlp").opset == 14
    assert hub.load("TinyMLP") == raw
    with pytest.raises(FileNotFoundError, match="missing from the local hub"):
        hub.load("TinyMLP", opset=9)
    with pytest.raises(KeyError):
        hub.get_model_info("nope")
    with pytest.raises(FileNotFoundError, match="manifest not found"):
        ONNXHub(str(tmp_path / "empty")).list_models()


# ---------------------------------------------------------------------------
# Booster.to_onnx
# ---------------------------------------------------------------------------

def _boosters(objective, **cfg):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 5)).astype(np.float32)
    X[rng.random(500) < 0.1, 1] = np.nan
    margin = X[:, 0] * X[:, 2] + 0.7 * np.nan_to_num(X[:, 1])
    if objective == "multiclass":
        y = np.digitize(margin, [-0.5, 0.5]).astype(np.float32)
    elif objective == "binary":
        y = (margin > 0).astype(np.float32)
    else:
        y = margin.astype(np.float32)
    jb = jboost.train_booster(X, y, jboost.BoosterConfig(
        objective=objective, num_iterations=4, num_leaves=7, **cfg))
    arrays, config = booster_arrays(jb)
    return X, jb, booster_from_reference(arrays, config, device=CPU)


@pytest.mark.parametrize("objective,cfg,out", [
    ("binary", dict(sigmoid=1.5), "probabilities"),
    ("multiclass", dict(num_class=3), "probabilities"),
    ("regression", {}, "variable")])
def test_booster_to_onnx_bytes_and_scores(objective, cfg, out):
    X, jb, tb = _boosters(objective, **cfg)
    raw = tb.to_onnx().encode()
    assert raw == j_to_onnx(jb).encode()
    stage = (ONNXModel(device=CPU).setModelPayload(raw)
             .setFeedDict({"input": "features"})
             .setFetchDict({"scores": out}).setMiniBatchSize(128))
    got = stage.transform(Table({"features": X}))["scores"]
    want = tb.predict(X)
    got = got[:, 1] if objective == "binary" else (
        got[:, 0] if objective == "regression" else got)
    np.testing.assert_allclose(got, want, rtol=TREE_RTOL,
                               atol=TREE_ATOL if objective != "regression"
                               else 1e-4)
