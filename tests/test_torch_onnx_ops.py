"""Every op of the JAX package's ONNX registry against the port's.

One case per name of ``synapseml_tpu.onnx.ops.REGISTRY`` (135), plus the
variants a name's attributes switch between (SAME padding, resize modes,
pad modes, reductions of the scatter family, RNN directions, ...). Each
case is a one-node graph written once with the port's protobuf writer;
both packages parse the same bytes, get the same seeded numpy inputs (the
JAX side under ``jax.jit``, as its ``ONNXModel`` runs it) and their
outputs are compared:

* float32: rtol 1e-4 / atol 1e-4 (``tests/test_onnx_realmodel.py:47``);
  most agree to a few ulps;
* integers and booleans: exact (the quantized ops' integer outputs
  included);
* ``RandomUniform*`` and ``Multinomial``: bitwise (the port's threefry is
  ``jax.random``'s); ``RandomNormal*``: atol 2e-5 (torch's ``erfinv``
  against XLA's polynomial, a few ulps of values up to about 5).

Shape-carrying inputs are initializers, as the JAX package requires
constants there. Graph inputs reach the port as CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synapseml_tpu.onnx import Model as JModel
from synapseml_tpu.onnx import OnnxFunction as JOnnxFunction
from synapseml_tpu.onnx.ops import REGISTRY as JREGISTRY

from synapseml_tpu_torch.onnx import Model as TModel
from synapseml_tpu_torch.onnx import OnnxFunction as TOnnxFunction
from synapseml_tpu_torch.onnx.modelgen import _attr
from synapseml_tpu_torch.onnx.ops import REGISTRY as TREGISTRY
from synapseml_tpu_torch.onnx.protoio import (Attribute, Graph, Node, Tensor,
                                              ValueInfo)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

RTOL = ATOL = 1e-4
NORMAL_ATOL = 2e-5


class X:
    """A graph input (fed at call time)."""

    def __init__(self, value):
        self.value = np.asarray(value)


class C:
    """An initializer (a constant of the graph)."""

    def __init__(self, value):
        self.value = np.asarray(value)


def _strs(name, values):
    return Attribute(name=name, type=8, strings=[v.encode() for v in values])


def _tensor_attr(name, arr):
    return Attribute(name=name, type=4, t=Tensor.from_array(name, arr))


def graph(op, ins, attrs=None, n_out=1, domain=""):
    """(model bytes, feeds) of a one-node graph over ``ins`` (``X``, ``C``
    or None for a skipped optional input)."""
    names, feeds, inits, vis = [], {}, {}, []
    for i, item in enumerate(ins):
        if item is None:
            names.append("")
        elif isinstance(item, X):
            nm = f"x{i}"
            feeds[nm] = item.value
            vis.append(ValueInfo(name=nm, elem_type=1,
                                 shape=list(item.value.shape)))
            names.append(nm)
        else:
            nm = f"c{i}"
            inits[nm] = Tensor.from_array(nm, item.value)
            names.append(nm)
    outs = [f"y{i}" for i in range(n_out)]
    attrs = {k: (v if isinstance(v, Attribute) else _attr(k, v))
             for k, v in (attrs or {}).items()}
    node = Node(op_type=op, inputs=names, outputs=outs, name="n0",
                attrs=attrs, domain=domain)
    g = Graph(nodes=[node], initializers=inits, inputs=vis,
              outputs=[ValueInfo(name=o, shape=["?"]) for o in outs],
              name=op)
    return TModel(graph=g, opset=17).encode(), feeds


def run_both(raw, feeds, precision="float32"):
    jfn = JOnnxFunction(JModel.parse(raw), precision=precision)
    fn, names = jfn.as_jax(list(feeds))
    jout = dict(zip(jfn.outputs, jax.jit(fn)(*[jnp.asarray(feeds[n])
                                                for n in names])))
    tfn = TOnnxFunction(TModel.parse(raw), precision=precision, device="cpu")
    tout = tfn({k: torch.from_numpy(np.array(v)) for k, v in feeds.items()})
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in tout.items()})


def check(raw, feeds, exact=False, atol=ATOL):
    want, got = run_both(raw, feeds)
    assert set(want) == set(got)
    for k in want:
        w, g = want[k], got[k]
        assert w.shape == g.shape, (k, w.shape, g.shape)
        if exact or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol,
                                       err_msg=k)


R = np.random.default_rng(0)


def f32(*shape, lo=-2.0, hi=2.0):
    return R.uniform(lo, hi, size=shape).astype(np.float32)


def i64(*vals):
    return np.asarray(vals, np.int64)


def _tree_attrs(kind):
    """Two depth-2 trees on 3 features: every branch mode, a NaN-tracking
    node, and one leaf table per output."""
    modes = ["BRANCH_LEQ", "BRANCH_GT", "LEAF", "LEAF", "LEAF",
             "BRANCH_LT", "BRANCH_GTE", "LEAF", "LEAF", "LEAF"]
    a = {"nodes_treeids": [0] * 5 + [1] * 5,
         "nodes_nodeids": [0, 1, 2, 3, 4] * 2,
         "nodes_featureids": [0, 1, 0, 0, 0, 2, 0, 0, 0, 0],
         "nodes_values": Attribute(name="nodes_values", type=6, floats=[
             0.1, -0.3, 0, 0, 0, 0.5, 0.0, 0, 0, 0]),
         "nodes_modes": _strs("nodes_modes", modes),
         "nodes_truenodeids": [1, 3, 2, 3, 4, 1, 3, 2, 3, 4],
         "nodes_falsenodeids": [2, 4, 2, 3, 4, 2, 4, 2, 3, 4],
         "nodes_missing_value_tracks_true": [1, 0, 0, 0, 0, 0, 1, 0, 0, 0]}
    leaves_t = [0, 0, 0, 1, 1, 1]
    leaves_n = [2, 3, 4, 2, 3, 4]
    w = Attribute(name="w", type=6, floats=[0.3, -0.2, 0.7, 0.1, 0.4, -0.5])
    if kind == "classifier":
        a.update({"class_treeids": leaves_t, "class_nodeids": leaves_n,
                  "class_ids": [0, 1, 2, 1, 2, 0],
                  "class_weights": Attribute(name="class_weights", type=6,
                                             floats=w.floats),
                  "classlabels_int64s": [10, 20, 30],
                  "post_transform": "SOFTMAX"})
    else:
        a.update({"target_treeids": leaves_t, "target_nodeids": leaves_n,
                  "target_ids": [0] * 6, "n_targets": 1,
                  "target_weights": Attribute(name="target_weights", type=6,
                                              floats=w.floats),
                  "base_values": Attribute(name="base_values", type=6,
                                           floats=[0.25]),
                  "aggregate_function": "SUM"})
    return a


def _tree_input():
    x = f32(16, 3)
    x[3, 0] = np.nan
    x[5, 2] = np.nan
    return x


def _rnn_inputs(gates, hidden=4, inp=3, seq=5, batch=2, dirs=1, bias=True):
    ins = [X(f32(seq, batch, inp)), C(f32(dirs, gates * hidden, inp) * 0.5),
           C(f32(dirs, gates * hidden, hidden) * 0.5)]
    ins.append(C(f32(dirs, 2 * gates * hidden) * 0.3) if bias else None)
    return ins


def _nms_boxes():
    base = np.asarray([[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, -0.1, 1, 0.9],
                       [0, 10, 1, 11], [0, 10.1, 1, 11.1],
                       [0, 100, 1, 101]], np.float32)
    return np.stack([base, base[::-1]])                 # (2, 6, 4)


_BOXES = _nms_boxes()
_SCORES = np.stack([np.stack([
    np.asarray([0.9, 0.75, 0.6, 0.95, 0.5, 0.3], np.float32),
    np.asarray([0.1, 0.2, 0.8, 0.05, 0.9, 0.4], np.float32)])] * 2)

# name -> list of (id, build) where build() -> (raw, feeds, check kwargs)
CASES = {}


def case(name, cid="", **kw):
    def deco(build):
        CASES.setdefault(name, []).append((cid or name, build, kw))
        return build
    return deco


def simple(name, ins, attrs=None, n_out=1, cid="", domain="", **kw):
    CASES.setdefault(name, []).append(
        (cid or name, lambda: graph(name, ins, attrs, n_out, domain), kw))


# --- elementwise ------------------------------------------------------------
for _n in ("Add", "Sub", "Mul", "Min", "Max"):
    simple(_n, [X(f32(3, 4)), X(f32(4))])
simple("Div", [X(f32(3, 4)), C(f32(3, 4, lo=0.5, hi=2))])
simple("Div", [C(i64(7, -7, 9)), C(i64(2, 2, 4))], cid="Div-int")
simple("Pow", [X(f32(3, 4, lo=0.1, hi=3)), X(f32(3, 4))])
simple("Sum", [X(f32(2, 3)), X(f32(3)), X(f32(2, 3))])
simple("Mod", [X(np.asarray([7, -7, 9, -9], np.int64)),
               C(np.asarray([3, 3, -4, -4], np.int64))])
simple("Mod", [X(f32(6)), C(f32(6, lo=0.5, hi=1.5))], {"fmod": 1},
       cid="Mod-fmod")
for _n in ("And", "Or", "Xor"):
    simple(_n, [X(R.random((3, 4)) > 0.5), X(R.random((4,)) > 0.5)])
for _n in ("Equal", "Greater", "Less"):
    simple(_n, [X(np.round(f32(3, 4))), X(np.round(f32(4)))])
simple("Where", [X(R.random((3, 4)) > 0.5), X(f32(3, 4)), X(f32(4))])
simple("BitShift", [X(np.asarray([1, 7, 200, 3], np.uint8)),
                    C(np.asarray([1, 2, 1, 3], np.uint8))],
       {"direction": "LEFT"})
simple("BitShift", [X(np.asarray([1, 7, 200, 3], np.uint8)),
                    C(np.asarray([1, 2, 1, 3], np.uint8))],
       {"direction": "RIGHT"}, cid="BitShift-right")

# --- unary ------------------------------------------------------------------
for _n in ("Neg", "Exp", "Abs", "Erf", "Relu", "Sigmoid", "Tanh", "Floor",
           "Ceil", "Round", "Sin", "Cos", "Softplus", "Mish", "HardSwish",
           "Sign", "Identity", "Dropout"):
    simple(_n, [X(f32(3, 5) * 3)])
simple("Sqrt", [X(f32(3, 5, lo=0.01, hi=4))])
simple("Log", [X(f32(3, 5, lo=0.01, hi=4))])
simple("Reciprocal", [X(f32(3, 5, lo=0.5, hi=4))])
simple("LeakyRelu", [X(f32(3, 5))], {"alpha": 0.2})
simple("Gelu", [X(f32(3, 5) * 3)])
simple("Gelu", [X(f32(3, 5) * 3)], {"approximate": "tanh"}, cid="Gelu-tanh")
simple("Clip", [X(f32(3, 5) * 3), C(np.float32(-1)), C(np.float32(1.5))])
simple("Not", [X(R.random((3, 4)) > 0.5)])
simple("Cast", [X(f32(3, 4) * 5)], {"to": 6})
simple("Cast", [X(np.arange(6, dtype=np.int64))], {"to": 1}, cid="Cast-f")
simple("PRelu", [X(f32(2, 3, 4, 4)), C(f32(3, 1, 1))])
simple("Elu", [X(f32(3, 5))], {"alpha": 0.7})
simple("Selu", [X(f32(3, 5))])
simple("HardSigmoid", [X(f32(3, 5) * 4)], {"alpha": 0.3, "beta": 0.4})
simple("Celu", [X(f32(3, 5))], {"alpha": 1.5})
simple("Shrink", [X(f32(3, 5))], {"lambd": 0.6, "bias": 0.2})
simple("ThresholdedRelu", [X(f32(3, 5))], {"alpha": 0.4})
simple("IsNaN", [X(np.asarray([0, np.nan, np.inf, -1], np.float32))])
simple("IsInf", [X(np.asarray([0, np.nan, np.inf, -np.inf], np.float32))])
simple("IsInf", [X(np.asarray([0, np.nan, np.inf, -np.inf], np.float32))],
       {"detect_positive": 0}, cid="IsInf-neg")
simple("Hardmax", [X(f32(3, 5))], {"axis": 1})

# --- reductions / normalization ----------------------------------------------
for _n in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceL2",
           "ReduceLogSumExp"):
    simple(_n, [X(f32(2, 3, 4))], {"axes": [1, 2], "keepdims": 0})
simple("ReduceProd", [X(f32(2, 3, 4, lo=0.5, hi=1.5))],
       {"axes": [0, 2], "keepdims": 1})
simple("ReduceSum", [X(f32(2, 3, 4)), C(i64(-1))], cid="ReduceSum-input")
simple("Softmax", [X(f32(2, 3, 4) * 3)], {"axis": 1})
simple("LogSoftmax", [X(f32(2, 3, 4) * 3)], {"axis": -1})
simple("ArgMax", [X(f32(3, 6))], {"axis": 1, "keepdims": 0})
simple("ArgMin", [X(f32(3, 6))], {"axis": 0})
simple("LayerNormalization", [X(f32(2, 3, 8)), C(f32(8)), C(f32(8))],
       {"axis": -1, "epsilon": 1e-5})
simple("LayerNormalization", [X(f32(2, 3, 8)), C(f32(3, 8))],
       {"axis": 1}, cid="LayerNormalization-2axes")
simple("BatchNormalization", [X(f32(2, 3, 4, 4)), C(f32(3)), C(f32(3)),
                              C(f32(3)), C(f32(3, lo=0.5, hi=2))])
simple("InstanceNormalization", [X(f32(2, 3, 5, 4)), C(f32(3)),
                                 C(f32(3))])
simple("GroupNormalization", [X(f32(2, 6, 4, 4)), C(f32(6)), C(f32(6))],
       {"num_groups": 3})
simple("GroupNormalization", [X(f32(2, 6, 4, 4)), C(f32(3)), C(f32(3))],
       {"num_groups": 3}, cid="GroupNormalization-per-group")
simple("LRN", [X(f32(2, 5, 3, 3))], {"size": 3, "alpha": 1e-3,
                                     "beta": 0.75, "bias": 1.0})

# --- products -----------------------------------------------------------------
simple("MatMul", [X(f32(2, 3, 5)), C(f32(5, 4))])
simple("Gemm", [X(f32(3, 5)), C(f32(4, 5)), C(f32(4))],
       {"transB": 1, "alpha": 0.5, "beta": 2.0})
simple("Gemm", [C(f32(5, 3)), X(f32(5, 4))], {"transA": 1},
       cid="Gemm-transA")
simple("Einsum", [X(f32(2, 3, 4)), X(f32(2, 4, 5))],
       {"equation": "bij,bjk->bik"})
simple("FusedMatMul", [X(f32(2, 4, 3)), X(f32(2, 5, 4))],
       {"transA": 1, "transB": 1, "alpha": 0.5}, domain="com.microsoft")

# --- convolution and pooling ----------------------------------------------------
simple("Conv", [X(f32(2, 3, 7, 6)), C(f32(4, 3, 3, 3)), C(f32(4))],
       {"strides": [2, 1], "pads": [1, 0, 2, 1], "kernel_shape": [3, 3]})
simple("Conv", [X(f32(1, 4, 6, 6)), C(f32(4, 2, 3, 3))],
       {"group": 2, "auto_pad": "SAME_LOWER", "strides": [2, 2],
        "dilations": [1, 1]}, cid="Conv-same-lower-grouped")
simple("Conv", [X(f32(1, 2, 9)), C(f32(3, 2, 3))],
       {"auto_pad": "SAME_UPPER", "strides": [2], "dilations": [2]},
       cid="Conv-1d-same-upper")
simple("ConvTranspose", [X(f32(1, 3, 4, 5)), C(f32(3, 2, 3, 3)),
                         C(f32(2))],
       {"strides": [2, 2], "pads": [1, 0, 0, 1], "output_padding": [1, 1]})
simple("MaxPool", [X(f32(2, 3, 7, 7))],
       {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]})
simple("MaxPool", [X(f32(1, 2, 6, 6))],
       {"kernel_shape": [2, 2], "strides": [2, 2], "auto_pad": "SAME_UPPER"},
       cid="MaxPool-same")
simple("AveragePool", [X(f32(2, 3, 7, 7))],
       {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 0, 1, 2]})
simple("AveragePool", [X(f32(2, 3, 7, 7))],
       {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1],
        "count_include_pad": 1}, cid="AveragePool-include-pad")
simple("GlobalAveragePool", [X(f32(2, 3, 5, 4))])
simple("GlobalMaxPool", [X(f32(2, 3, 5, 4))])

# --- shape plumbing ---------------------------------------------------------------
simple("Reshape", [X(f32(2, 3, 4)), C(i64(0, -1, 2))])
simple("Flatten", [X(f32(2, 3, 4))], {"axis": 2})
simple("Transpose", [X(f32(2, 3, 4))], {"perm": [2, 0, 1]})
simple("Concat", [X(f32(2, 3)), X(f32(2, 1)), C(f32(2, 2))], {"axis": 1})
simple("Split", [X(f32(2, 6)), C(i64(1, 2, 3))], {"axis": 1}, n_out=3)
simple("Split", [X(f32(6, 2))], n_out=3, cid="Split-equal")
simple("Squeeze", [X(f32(2, 1, 3, 1)), C(i64(1, -1))])
simple("Unsqueeze", [X(f32(2, 3)), C(i64(0, -1))])
simple("Gather", [X(f32(5, 3)), C(np.asarray([[0, -1], [2, 4]], np.int64))],
       {"axis": 0})
simple("Gather", [X(f32(3, 5)), C(np.int64(-2))], {"axis": 1},
       cid="Gather-scalar")
simple("Slice", [X(f32(5, 6)), C(i64(4, 1)), C(i64(0, 2 ** 62)),
                 C(i64(0, 1)), C(i64(-2, 2))])
simple("Expand", [X(f32(3, 1)), C(i64(2, 1, 4))])
simple("Shape", [X(f32(2, 3, 4))])
simple("Constant", [], {"value": _tensor_attr("value", f32(2, 3))})
simple("Constant", [], {"value_float": 2.5}, cid="Constant-float")
simple("ConstantOfShape", [C(i64(2, 3))],
       {"value": _tensor_attr("value", np.asarray([7], np.int32))})
simple("Pad", [X(f32(2, 3, 4)), C(i64(0, 1, 2, 0, 2, 1)), C(np.float32(0.5))])
simple("Pad", [X(f32(2, 5, 4)), C(i64(0, 2, 1, 0, 3, 2))],
       {"mode": "reflect"}, cid="Pad-reflect")
simple("Pad", [X(f32(2, 5, 4)), C(i64(1, 2, 0, 3)), None, C(i64(0, 2))],
       {"mode": "edge"}, cid="Pad-edge-axes")
simple("Tile", [X(f32(2, 3)), C(i64(2, 3))])
simple("Range", [C(np.int64(2)), C(np.int64(11)), C(np.int64(3))])
simple("Range", [C(np.float32(0.5)), C(np.float32(3.0)),
                 C(np.float32(0.75))], cid="Range-float")
simple("Resize", [X(f32(1, 2, 5, 6)), None, C(np.asarray(
    [1, 1, 2, 0.5], np.float32))], {"mode": "linear"})
simple("Resize", [X(f32(1, 2, 5, 6)), None, None, C(i64(1, 2, 8, 4))],
       {"mode": "cubic"}, cid="Resize-cubic-sizes")
simple("Resize", [X(f32(1, 2, 5, 6)), None, C(np.asarray(
    [1, 1, 2, 1.5], np.float32))], {"mode": "nearest"},
    cid="Resize-nearest")
simple("CumSum", [X(f32(3, 4)), C(np.int64(1))])
simple("CumSum", [X(f32(3, 4)), C(np.int64(0))],
       {"exclusive": 1, "reverse": 1}, cid="CumSum-exclusive-reverse")
simple("OneHot", [X(np.asarray([[0, 2], [-1, 5]], np.int64)), C(np.int64(4)),
                  C(np.asarray([-1.0, 3.0], np.float32))], {"axis": 1})
simple("TopK", [X(f32(3, 7)), C(i64(3))], {"axis": 1}, n_out=2)
simple("TopK", [X(f32(5, 3)), C(i64(2))], {"axis": 0, "largest": 0},
       n_out=2, cid="TopK-smallest")
simple("Trilu", [X(f32(2, 4, 5)), C(np.int64(1))])
simple("Trilu", [X(f32(4, 5))], {"upper": 0}, cid="Trilu-lower")
simple("DepthToSpace", [X(f32(1, 8, 2, 3))], {"blocksize": 2})
simple("DepthToSpace", [X(f32(1, 8, 2, 3))], {"blocksize": 2,
                                              "mode": "CRD"},
       cid="DepthToSpace-crd")
simple("SpaceToDepth", [X(f32(1, 2, 4, 6))], {"blocksize": 2})
simple("EyeLike", [X(f32(3, 5))], {"k": 1})
simple("Det", [X(f32(2, 3, 3))])

# --- scatter / gather -------------------------------------------------------------
simple("GatherElements", [X(f32(3, 4)), C(np.asarray(
    [[0, -1, 2, 1], [2, 2, 0, 0]], np.int64))], {"axis": 0})
simple("ScatterElements", [X(f32(3, 4)), C(np.asarray(
    [[0, 1, 2, 0], [2, 0, 1, 1]], np.int64)), X(f32(2, 4))], {"axis": 0})
simple("ScatterElements", [X(f32(3, 4)), C(np.asarray(
    [[0, 1, 0, 0], [0, 1, 1, 0]], np.int64)), X(f32(2, 4))],
    {"axis": 0, "reduction": "add"}, cid="ScatterElements-add")
simple("ScatterElements", [X(f32(3, 4)), C(np.asarray(
    [[0, 1, 0, 0], [0, 1, 1, 0]], np.int64)), X(f32(2, 4))],
    {"axis": 0, "reduction": "max"}, cid="ScatterElements-max")
simple("GatherND", [X(f32(3, 4, 2)), C(np.asarray([[0, 1], [2, 3]],
                                                  np.int64))])
simple("ScatterND", [X(f32(3, 4)), C(np.asarray([[1], [2]], np.int64)),
                     X(f32(2, 4))])
simple("ScatterND", [X(f32(3, 4)), C(np.asarray([[1, 0], [1, 0], [2, 3]],
                                                np.int64)), X(f32(3))],
       {"reduction": "add"}, cid="ScatterND-add")
simple("ScatterND", [X(f32(3, 4)), C(np.asarray([[1, 0], [1, 0], [2, 3]],
                                                np.int64)), X(f32(3))],
       {"reduction": "min"}, cid="ScatterND-min")

# --- recurrent --------------------------------------------------------------------
simple("RNN", _rnn_inputs(1), {"hidden_size": 4}, n_out=2)
simple("RNN", _rnn_inputs(1, dirs=2), {"hidden_size": 4,
                                       "direction": "bidirectional",
                                       "activations": _strs(
                                           "activations", ["Relu", "Tanh"])},
       n_out=2, cid="RNN-bidirectional")
simple("GRU", _rnn_inputs(3), {"hidden_size": 4,
                               "linear_before_reset": 1}, n_out=2)
simple("GRU", _rnn_inputs(3, bias=False), {"hidden_size": 4,
                                           "direction": "reverse"},
       n_out=2, cid="GRU-reverse")
simple("LSTM", _rnn_inputs(4) + [None, X(f32(1, 2, 4)), X(f32(1, 2, 4)),
                                  C(f32(1, 12))],
       {"hidden_size": 4}, n_out=3)
simple("LSTM", _rnn_inputs(4, dirs=2), {"hidden_size": 4,
                                        "direction": "bidirectional",
                                        "clip": 0.5},
       n_out=3, cid="LSTM-bidirectional-clip")

# --- tree ensembles ----------------------------------------------------------------
simple("TreeEnsembleClassifier", [X(_tree_input())],
       _tree_attrs("classifier"), n_out=2, domain="ai.onnx.ml")
simple("TreeEnsembleRegressor", [X(_tree_input())],
       _tree_attrs("regressor"), domain="ai.onnx.ml")

# --- quantized ---------------------------------------------------------------------
simple("DequantizeLinear", [X(np.asarray([[0, 128, 255], [7, 3, 9]],
                                         np.uint8)),
                            C(np.asarray([0.5, 0.25, 2.0], np.float32)),
                            C(np.asarray([128, 0, 3], np.uint8))],
       {"axis": 1})
simple("QuantizeLinear", [X(f32(2, 5) * 40), C(np.float32(0.3)),
                          C(np.int8(-3))])
simple("QuantizeLinear", [X(f32(2, 5) * 40), C(np.float32(0.3))],
       cid="QuantizeLinear-uint8-default")
simple("DynamicQuantizeLinear", [X(f32(3, 4) * 3)], n_out=3)
simple("QLinearConv", [X(R.integers(0, 255, (1, 2, 5, 5)).astype(np.uint8)),
                       C(np.float32(0.02)), C(np.uint8(100)),
                       C(R.integers(-60, 60, (3, 2, 3, 3)).astype(np.int8)),
                       C(np.asarray([0.01, 0.02, 0.015], np.float32)),
                       C(np.zeros(3, np.int8)), C(np.float32(0.05)),
                       C(np.uint8(120)),
                       C(np.asarray([10, -20, 30], np.int32))],
       {"pads": [1, 1, 1, 1]})
simple("QLinearMatMul", [X(R.integers(0, 255, (2, 3, 4)).astype(np.uint8)),
                         C(np.float32(0.05)), C(np.uint8(128)),
                         C(R.integers(0, 255, (4, 5)).astype(np.uint8)),
                         C(np.float32(0.04)), C(np.uint8(120)),
                         C(np.float32(0.1)), C(np.uint8(100))])
simple("MatMulInteger", [X(R.integers(0, 255, (3, 6)).astype(np.uint8)),
                         C(R.integers(-128, 127, (6, 4)).astype(np.int8)),
                         C(np.asarray([3, 5, 7], np.uint8)),
                         C(np.int8(-2))])
simple("ConvInteger", [X(R.integers(0, 255, (1, 2, 5, 5)).astype(np.uint8)),
                       C(R.integers(-128, 127, (3, 2, 3, 3)).astype(np.int8)),
                       C(np.uint8(7)),
                       C(np.asarray([1, -2, 3], np.int8))],
       {"pads": [0, 1, 1, 0], "strides": [2, 1]})

# --- detection -----------------------------------------------------------------------
simple("RoiAlign", [X(f32(2, 3, 8, 8)),
                    C(np.asarray([[0.5, 1, 5.5, 6], [1, 0, 7, 3.5],
                                  [2, 2, 2.5, 7]], np.float32)),
                    C(np.asarray([0, 1, 1], np.int64))],
       {"output_height": 2, "output_width": 3, "sampling_ratio": 2,
        "spatial_scale": 0.9})
simple("RoiAlign", [X(f32(1, 2, 6, 6)),
                    C(np.asarray([[0.5, 1, 4.5, 5]], np.float32)),
                    C(np.asarray([0], np.int64))],
       {"output_height": 2, "output_width": 2, "mode": "max",
        "coordinate_transformation_mode": "output_half_pixel"},
       cid="RoiAlign-max-legacy")
simple("NonMaxSuppression", [X(_BOXES), X(_SCORES), C(i64(3)),
                             C(np.float32(0.5)), C(np.float32(0.2))])
simple("NonMaxSuppression", [X(_BOXES[..., [1, 0, 3, 2]]), X(_SCORES),
                             C(i64(2))], {"center_point_box": 1},
       cid="NonMaxSuppression-center")

# --- contrib fusions -----------------------------------------------------------------
_B, _S, _H = 2, 5, 8
simple("Attention", [X(f32(_B, _S, _H)), C(f32(_H, 3 * _H) * 0.5),
                     C(f32(3 * _H)),
                     X(np.asarray([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]],
                                  np.int32))],
       {"num_heads": 2}, domain="com.microsoft")
simple("Attention", [X(f32(_B, _S, _H)), C(f32(_H, 3 * _H) * 0.5)],
       {"num_heads": 2, "unidirectional": 1, "scale": 0.3},
       domain="com.microsoft", cid="Attention-causal-scale")
simple("MultiHeadAttention", [X(f32(_B, _S, _H)), X(f32(_B, 4, _H)),
                              X(f32(_B, 4, _H)), C(f32(3 * _H)),
                              X(np.asarray([[1, 1, 0, 0], [1, 1, 1, 1]],
                                           np.int32))],
       {"num_heads": 2}, domain="com.microsoft")
simple("SkipLayerNormalization", [X(f32(_B, _S, _H)), X(f32(_B, _S, _H)),
                                  C(f32(_H)), C(f32(_H)), C(f32(_H))],
       n_out=4, domain="com.microsoft")
simple("EmbedLayerNormalization", [
    X(np.asarray([[1, 5, 3, 0, 2], [4, 4, 1, 2, 6]], np.int32)),
    X(np.asarray([[0, 0, 1, 1, 1], [0, 1, 1, 1, 1]], np.int32)),
    # tables as graph inputs: the JAX op indexes them with traced ids
    X(f32(7, _H)), X(f32(6, _H)), X(f32(2, _H)), C(f32(_H)), C(f32(_H)),
    X(np.asarray([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32))],
    n_out=2, domain="com.microsoft")
simple("FastGelu", [X(f32(2, 6) * 3), C(f32(6))], domain="com.microsoft")
simple("BiasGelu", [X(f32(2, 6) * 3), C(f32(6))], domain="com.microsoft")
simple("QuickGelu", [X(f32(2, 6) * 3)], {"alpha": 1.5},
       domain="com.microsoft")

# --- sampling ------------------------------------------------------------------------
_GRID = f32(2, 4, 5, 2, lo=-1.2, hi=1.2)
simple("GridSample", [X(f32(2, 3, 6, 7)), X(_GRID)], {"align_corners": 0})
simple("GridSample", [X(f32(2, 3, 6, 7)), X(_GRID)],
       {"align_corners": 1, "mode": "nearest", "padding_mode": "border"},
       cid="GridSample-nearest-border")

# --- random (deterministic) --------------------------------------------------------------
simple("RandomUniform", [], {"shape": [3, 50], "low": -1.0, "high": 2.0,
                             "seed": 11.0}, exact=True)
simple("RandomUniform", [], {"shape": [40]}, cid="RandomUniform-seedless",
       exact=True)
simple("RandomUniformLike", [X(f32(4, 30))], {"low": 2.0, "high": 4.0},
       exact=True)
simple("RandomNormal", [], {"shape": [3, 50], "mean": 1.0, "scale": 2.0,
                            "seed": 7.0}, atol=NORMAL_ATOL)
simple("RandomNormalLike", [X(f32(4, 30))], {"seed": 3.0},
       atol=NORMAL_ATOL)
simple("Multinomial", [X(np.log(np.asarray([[0.8, 0.1, 0.1],
                                            [0.05, 0.9, 0.05]],
                                           np.float32)))],
       {"sample_size": 200, "seed": 5.0})


def _ids():
    return [(name, cid) for name in sorted(CASES) for cid, _, _ in
            CASES[name]]


def test_every_reference_op_has_a_case_and_a_port():
    assert set(TREGISTRY) == set(JREGISTRY)
    assert len(JREGISTRY) == 135
    assert set(CASES) == set(JREGISTRY)


@pytest.mark.parametrize("name,cid", _ids(), ids=[c for _, c in _ids()])
def test_op_matches_the_reference(name, cid):
    build, kw = next((b, k) for c, b, k in CASES[name] if c == cid)
    raw, feeds = build()
    check(raw, feeds, **kw)


@pytest.mark.parametrize("name", ["Conv", "MatMul", "Gemm", "Resize",
                                  "LayerNormalization", "Softmax"])
def test_bf16_ops_match_the_reference(name):
    """bfloat16 mode: the same one-node graphs in bf16 on both sides.
    Both round inputs, weights and outputs to bf16 (products accumulate in
    float32 on both); the sums run in another order, so outputs may differ
    by an ulp of bf16: |gap| <= 2^-7 * (1 + |y|)."""
    cid, build, _ = CASES[name][0]
    raw, feeds = build()
    want, got = run_both(raw, feeds, precision="bfloat16")
    for k in want:
        w = want[k].astype(np.float32)
        assert got[k].dtype == np.float32
        np.testing.assert_array_less(np.abs(got[k] - w),
                                     2.0 ** -7 * (1 + np.abs(w)) + 1e-30)


def test_uniform_draws_are_jax_random_bitwise():
    """``core/prng.py``'s new draws against ``jax.random`` directly."""
    from synapseml_tpu_torch.core import prng

    for seed, shape, lo, hi in ((0, (7, 9), -3.0, 5.0), (2 ** 31 + 5, (300,),
                                                         0.0, 1.0)):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            prng.uniform_range(prng.prng_key(seed), shape, lo, hi).numpy(),
            np.asarray(jax.random.uniform(key, shape, minval=lo,
                                          maxval=hi)))
        np.testing.assert_allclose(
            prng.normal(prng.prng_key(seed), shape).numpy(),
            np.asarray(jax.random.normal(key, shape)), rtol=0,
            atol=NORMAL_ATOL)
    logits = np.log(np.random.default_rng(1).dirichlet(np.ones(5), 4)
                    ).astype(np.float32)
    np.testing.assert_array_equal(
        prng.categorical(prng.prng_key(9), torch.from_numpy(logits),
                         (6, 4)).numpy(),
        np.asarray(jax.random.categorical(jax.random.PRNGKey(9), logits,
                                          axis=-1, shape=(6, 4))))


def test_shape_inputs_must_be_host_values():
    """A shape computed on the device is refused by name, never read back
    (a read would sync the stream and fail a CUDA graph capture)."""
    n1 = Node(op_type="Abs", inputs=["s"], outputs=["t"], name="abs")
    n2 = Node(op_type="Reshape", inputs=["x", "t"], outputs=["y"],
              name="reshape")
    g = Graph(nodes=[n1, n2], initializers={},
              inputs=[ValueInfo(name="x", shape=[2, 3]),
                      ValueInfo(name="s", elem_type=7, shape=[2])],
              outputs=[ValueInfo(name="y", shape=[3, 2])])
    fn = TOnnxFunction(TModel(graph=g), device="cpu")
    with pytest.raises(ValueError, match="shape must be a constant"):
        fn({"x": np.zeros((2, 3), np.float32),
            "s": np.asarray([3, 2], np.int64)})
