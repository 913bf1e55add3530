"""Deterministic ONNX model generators — real-architecture graphs for tests
and benchmarks: a >=50-node model with conv / pool / gemm / layernorm /
attention ops, exercised end-to-end through the importer and ONNXModel.

The port's own copy of the JAX package's ``onnx/modelgen.py``: the same
seed gives the same bytes, so both packages can score one graph.

The zero-egress environment has no model zoo, so the "real pretrained model"
is generated: genuine ResNet architecture (bottleneck residual blocks,
BatchNormalization folded as inference-mode) and a genuine transformer
encoder (multi-head self-attention + LayerNormalization + GELU MLP), with
seeded random weights, written through our own protobuf writer
(onnx/protoio.py) so the bytes are a spec-conformant .onnx file.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .protoio import Attribute, Graph, Model, Node, Tensor, ValueInfo

_F32 = 1  # TensorProto.FLOAT


def _attr(name: str, v) -> Attribute:
    if isinstance(v, bool):
        return Attribute(name=name, type=2, i=int(v))
    if isinstance(v, int):
        return Attribute(name=name, type=2, i=v)
    if isinstance(v, float):
        return Attribute(name=name, type=1, f=v)
    if isinstance(v, str):
        return Attribute(name=name, type=3, s=v.encode())
    if isinstance(v, (list, tuple)):
        if all(isinstance(x, int) for x in v):
            return Attribute(name=name, type=7, ints=list(v))
        return Attribute(name=name, type=6, floats=[float(x) for x in v])
    raise TypeError(f"unsupported attribute value {v!r}")


def _vi(name: str, shape) -> ValueInfo:
    return ValueInfo(name=name, elem_type=_F32, shape=list(shape))


class _G:
    """Tiny graph builder: tracks nodes, initializers, and a name counter."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.nodes: List[Node] = []
        self.inits = {}
        self.n = 0

    def name(self, op: str) -> str:
        self.n += 1
        return f"{op.lower()}_{self.n}"

    def weight(self, shape, scale=None) -> str:
        nm = f"w_{self.n}_{'x'.join(map(str, shape))}"
        self.n += 1
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        s = scale if scale is not None else 1.0 / max(np.sqrt(fan_in), 1.0)
        arr = (self.rng.standard_normal(shape) * s).astype(np.float32)
        self.inits[nm] = Tensor.from_array(nm, arr)
        return nm

    def const(self, arr, nm=None) -> str:
        nm = nm or f"c_{self.n}"
        self.n += 1
        self.inits[nm] = Tensor.from_array(nm, np.asarray(arr))
        return nm

    def add(self, op: str, inputs, attrs=None, out=None) -> str:
        out = out or self.name(op)
        self.nodes.append(Node(op_type=op, inputs=list(inputs), outputs=[out],
                               name=out,
                               attrs={k: _attr(k, v) for k, v in
                                      (attrs or {}).items()}))
        return out

    def conv(self, x, cin, cout, k, stride=1) -> str:
        w = self.weight((cout, cin, k, k))
        pad = k // 2
        return self.add("Conv", [x, w],
                        {"strides": [stride, stride],
                         "pads": [pad, pad, pad, pad],
                         "kernel_shape": [k, k]})

    def bn(self, x, c) -> str:
        scale = self.const(np.abs(self.rng.standard_normal(c)).astype(np.float32) * 0.5 + 0.75)
        bias = self.const((self.rng.standard_normal(c) * 0.1).astype(np.float32))
        mean = self.const((self.rng.standard_normal(c) * 0.1).astype(np.float32))
        var = self.const(np.abs(self.rng.standard_normal(c)).astype(np.float32) * 0.1 + 0.9)
        return self.add("BatchNormalization", [x, scale, bias, mean, var],
                        {"epsilon": 1e-5})


def make_resnet(depth: int = 50, num_classes: int = 1000, seed: int = 0,
                image_size: int = 224) -> Model:
    """Genuine ResNet graph (bottleneck for depth>=50, basic blocks below);
    input 'data' (N, 3, S, S) → output 'logits' (N, num_classes)."""
    cfgs = {18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
            50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True)}
    blocks, bottleneck = cfgs[depth]
    g = _G(seed)
    x = g.conv("data", 3, 64, 7, stride=2)
    x = g.bn(x, 64)
    x = g.add("Relu", [x])
    x = g.add("MaxPool", [x], {"kernel_shape": [3, 3], "strides": [2, 2],
                               "pads": [1, 1, 1, 1]})
    cin = 64
    widths = [64, 128, 256, 512]
    for stage, (w, nb) in enumerate(zip(widths, blocks)):
        for b in range(nb):
            stride = 2 if (stage > 0 and b == 0) else 1
            cout = w * (4 if bottleneck else 1)
            shortcut = x
            if stride != 1 or cin != cout:
                shortcut = g.conv(x, cin, cout, 1, stride)
                shortcut = g.bn(shortcut, cout)
            if bottleneck:
                y = g.conv(x, cin, w, 1)
                y = g.bn(y, w)
                y = g.add("Relu", [y])
                y = g.conv(y, w, w, 3, stride)
                y = g.bn(y, w)
                y = g.add("Relu", [y])
                y = g.conv(y, w, cout, 1)
                y = g.bn(y, cout)
            else:
                y = g.conv(x, cin, w, 3, stride)
                y = g.bn(y, w)
                y = g.add("Relu", [y])
                y = g.conv(y, w, cout, 3)
                y = g.bn(y, cout)
            x = g.add("Add", [y, shortcut])
            x = g.add("Relu", [x], out=f"stage{stage}_block{b}_out")
            cin = cout
    x = g.add("GlobalAveragePool", [x])
    x = g.add("Flatten", [x], {"axis": 1}, out="features")
    wfc = g.weight((cin, num_classes))
    bfc = g.const(np.zeros(num_classes, np.float32))
    g.add("Gemm", ["features", wfc, bfc], {"alpha": 1.0, "beta": 1.0},
          out="logits")
    graph = Graph(nodes=g.nodes, initializers=g.inits,
                  inputs=[_vi("data", ["N", 3, image_size, image_size])],
                  outputs=[_vi("logits", ["N", num_classes])],
                  name=f"resnet{depth}")
    return Model(graph=graph, opset=13)


def make_transformer_encoder(num_layers: int = 2, d_model: int = 64,
                             num_heads: int = 4, seq_len: int = 32,
                             d_ff: int = 256, num_classes: int = 2,
                             seed: int = 1) -> Model:
    """Transformer encoder (pre-LN, full multi-head self-attention with
    Transpose/MatMul/Softmax, GELU MLP) over float input 'embeddings'
    (N, seq, d_model) → 'logits' (N, num_classes) via mean pooling."""
    g = _G(seed)
    hd = d_model // num_heads
    x = "embeddings"
    inv_sqrt = g.const(np.float32(1.0 / np.sqrt(hd)))
    for layer in range(num_layers):
        ln_s = g.const(np.ones(d_model, np.float32))
        ln_b = g.const(np.zeros(d_model, np.float32))
        h = g.add("LayerNormalization", [x, ln_s, ln_b], {"axis": -1,
                                                          "epsilon": 1e-5})
        # QKV projections
        heads_out = []
        proj = {}
        for nm in ("q", "k", "v"):
            w = g.weight((d_model, d_model))
            p = g.add("MatMul", [h, w])
            # (N, S, D) -> (N, S, H, hd) -> (N, H, S, hd)
            p = g.add("Reshape", [p, g.const(np.asarray([0, seq_len, num_heads,
                                                         hd], np.int64))])
            proj[nm] = g.add("Transpose", [p], {"perm": [0, 2, 1, 3]})
        kt = g.add("Transpose", [proj["k"]], {"perm": [0, 1, 3, 2]})
        att = g.add("MatMul", [proj["q"], kt])
        att = g.add("Mul", [att, inv_sqrt])
        att = g.add("Softmax", [att], {"axis": -1})
        ctx = g.add("MatMul", [att, proj["v"]])
        ctx = g.add("Transpose", [ctx], {"perm": [0, 2, 1, 3]})
        ctx = g.add("Reshape", [ctx, g.const(np.asarray([0, seq_len, d_model],
                                                        np.int64))])
        wo = g.weight((d_model, d_model))
        ctx = g.add("MatMul", [ctx, wo])
        x = g.add("Add", [x, ctx])
        # MLP
        ln2_s = g.const(np.ones(d_model, np.float32))
        ln2_b = g.const(np.zeros(d_model, np.float32))
        h2 = g.add("LayerNormalization", [x, ln2_s, ln2_b], {"axis": -1,
                                                             "epsilon": 1e-5})
        w1 = g.weight((d_model, d_ff))
        h2 = g.add("MatMul", [h2, w1])
        h2 = g.add("Gelu", [h2])
        w2 = g.weight((d_ff, d_model))
        h2 = g.add("MatMul", [h2, w2])
        x = g.add("Add", [x, h2], out=f"layer{layer}_out")
    pooled = g.add("ReduceMean", [x], {"axes": [1], "keepdims": 0},
                   out="pooled")
    wcls = g.weight((d_model, num_classes))
    bcls = g.const(np.zeros(num_classes, np.float32))
    g.add("Gemm", ["pooled", wcls, bcls], {"alpha": 1.0, "beta": 1.0},
          out="logits")
    graph = Graph(nodes=g.nodes, initializers=g.inits,
                  inputs=[_vi("embeddings", ["N", seq_len, d_model])],
                  outputs=[_vi("logits", ["N", num_classes])],
                  name="tiny_transformer_encoder")
    return Model(graph=graph, opset=13)


def make_unet(base: int = 8, depth: int = 3, image_size: int = 32,
              in_ch: int = 3, out_ch: int = 1, seed: int = 2) -> Model:
    """Genuine UNet encoder-decoder (Conv + GroupNorm + skip Concats,
    ConvTranspose upsampling, Sigmoid head) — exercises the extended op set
    the way segmentation/diffusion exports do."""
    g = _G(seed)

    def block(x, cin, cout):
        x = g.conv(x, cin, cout, 3)
        gs = g.const(np.ones(cout, np.float32))
        gb = g.const(np.zeros(cout, np.float32))
        x = g.add("GroupNormalization", [x, gs, gb],
                  {"num_groups": max(1, cout // 4), "epsilon": 1e-5})
        return g.add("HardSwish", [x])

    x = "image"
    skips = []
    ch = in_ch
    # encoder
    for d in range(depth):
        cout = base * (2 ** d)
        x = block(x, ch, cout)
        skips.append((x, cout))
        x = g.add("MaxPool", [x], {"kernel_shape": [2, 2],
                                   "strides": [2, 2]})
        ch = cout
    # bottleneck
    x = block(x, ch, ch * 2)
    ch = ch * 2
    # decoder
    for d in reversed(range(depth)):
        cskip = base * (2 ** d)
        wt = g.weight((ch, cskip, 2, 2))
        x = g.add("ConvTranspose", [x, wt],
                  {"strides": [2, 2], "kernel_shape": [2, 2]})
        skip, _ = skips[d]
        x = g.add("Concat", [x, skip], {"axis": 1})
        x = block(x, cskip * 2, cskip)
        ch = cskip
    w_head = g.weight((out_ch, ch, 1, 1))
    x = g.add("Conv", [x, w_head], {"kernel_shape": [1, 1]})
    g.add("Sigmoid", [x], out="mask")
    graph = Graph(nodes=g.nodes, initializers=g.inits,
                  inputs=[_vi("image", ["N", in_ch, image_size, image_size])],
                  outputs=[_vi("mask", ["N", out_ch, image_size, image_size])],
                  name="tiny_unet")
    return Model(graph=graph, opset=21)
