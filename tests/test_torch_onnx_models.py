"""Whole models through the port's ``ONNXModel`` against the JAX package.

The graphs of ``onnx/modelgen.py`` (the same bytes from both packages'
copies): ResNet-50 (``make_resnet(50, num_classes=10, image_size=32)``: 53
convolutions, bottlenecks, strided projections) and a 2-layer transformer
encoder, each through ``ONNXModel.transform`` with ``miniBatchSize`` 4 on 10
rows (two full batches and a tail padded to the runner's rung of 2), held
to the JAX ``OnnxFunction`` on all 10 rows at once:

* float32: rtol 1e-4 / atol 1e-4 (``tests/test_onnx_realmodel.py:47``);
* bfloat16 (``floatPrecision``), the encoder and a ResNet-18: both sides
  round every op's result to bf16 and accumulate products in float32, in
  another order, so each layer may differ by an ulp of bf16 (2^-8
  relative) and the gaps compound through the depth; the bound is 3% of
  the output's largest magnitude (measured: 1.7% on the ResNet-18, 0.45%
  on the encoder; the JAX package's own bf16 output is 1.1% and 0.7%
  from its float32 output).
"""

import numpy as np
import pytest

from synapseml_tpu.onnx import Model as JModel
from synapseml_tpu.onnx import OnnxFunction as JOnnxFunction
from synapseml_tpu.onnx import modelgen as jmodelgen

from synapseml_tpu_torch.core import Table
from synapseml_tpu_torch.onnx import Model, ONNXModel, modelgen
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

RTOL = ATOL = 1e-4
BF16_REL = 0.03
ROWS, BATCH = 10, 4

MODELS = {
    "resnet50": (lambda g: g.make_resnet(50, num_classes=10, image_size=32),
                 (3, 32, 32)),
    "resnet18": (lambda g: g.make_resnet(18, num_classes=10, image_size=32),
                 (3, 32, 32)),
    "encoder": (lambda g: g.make_transformer_encoder(num_layers=2),
                (32, 64)),
}


def _case(name):
    make, shape = MODELS[name]
    raw = make(modelgen).encode()
    assert raw == make(jmodelgen).encode()
    x = np.random.default_rng(0).normal(size=(ROWS,) + shape).astype(
        np.float32)
    return raw, x


def _transform(raw, x, precision):
    m = Model.parse(raw)
    in_name, out_name = m.graph.inputs[0].name, m.graph.outputs[0].name
    stage = (ONNXModel(device="cpu", floatPrecision=precision)
             .setModelPayload(raw).setMiniBatchSize(BATCH)
             .setFeedDict({in_name: "x"}).setFetchDict({"y": out_name}))
    out = stage.transform(Table({"x": x}))["y"]
    runner = next(iter(stage._runner_cache.values()))
    assert runner.stats()["compiles"] == {2: 1, BATCH: 1}
    return out


def _reference(raw, x, precision):
    fn = JOnnxFunction(JModel.parse(raw), precision=precision)
    return np.asarray(fn({fn.graph_inputs[0]: x})[fn.outputs[0]])


@pytest.mark.parametrize("name", ["resnet50", "encoder"])
def test_float32_model_matches_the_reference(name):
    raw, x = _case(name)
    if name == "resnet50":
        ops = [n.op_type for n in Model.parse(raw).graph.nodes]
        assert ops.count("Conv") == 53 and len(ops) >= 170
    got = _transform(raw, x, "float32")
    want = _reference(raw, x, "float32")
    assert got.shape == want.shape == (ROWS, 10 if "resnet" in name else 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["resnet18", "encoder"])
def test_bf16_model_matches_the_reference(name):
    raw, x = _case(name)
    got = _transform(raw, x, "bfloat16")
    want = _reference(raw, x, "bfloat16")
    assert got.dtype == np.float32
    gap = np.abs(got - want).max()
    assert gap <= BF16_REL * np.abs(want).max(), (gap, np.abs(want).max())
    # and bf16 stays near float32 (the rounding, not a wrong op)
    f32 = _reference(raw, x, "float32")
    assert np.abs(got - f32).max() <= 0.1 * np.abs(f32).max()
