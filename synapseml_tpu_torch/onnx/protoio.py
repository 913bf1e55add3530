"""Minimal protobuf wire-format IO for ONNX files.

The port's own copy of the JAX package's ``onnx/protoio.py`` (the port
imports nothing of that package); the bytes it reads and writes are the same.

The environment ships no ``onnx`` package, and the reference reads models
through ONNX Runtime's Java API (deep-learning/.../onnx/ONNXRuntime.scala:25-44)
— neither is a fit here. ONNX files are ordinary protobuf, and the subset of
messages needed for inference (ModelProto → GraphProto → Node/Tensor/
Attribute/ValueInfo) decodes with a ~hundred-line wire reader. A matching
writer exists so tests (and users) can construct models without external deps.

Field numbers follow onnx/onnx.proto3 (public schema):
  ModelProto:   ir_version=1, opset_import=8, graph=7
  GraphProto:   node=1, name=2, initializer=5, input=11, output=12
  NodeProto:    input=1, output=2, name=3, op_type=4, attribute=5
  AttributeProto: name=1, f=2, i=3, s=4, t=5, g=6, floats=7, ints=8, strings=9, type=20
  TensorProto:  dims=1, data_type=2, float_data=4, int32_data=5, string_data=6,
                int64_data=7, name=8, raw_data=9, double_data=10, uint64_data=11
  ValueInfoProto: name=1, type=2; TypeProto.tensor_type=1 {elem_type=1, shape=2}
  TensorShapeProto.dim=1 {dim_value=1, dim_param=2}
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# TensorProto.DataType enum (onnx.proto3)
DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
          6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
          12: np.uint32, 13: np.uint64}
DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


# --------------------------------------------------------------------------
# wire primitives

def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:  # int64 negatives (e.g. -1 dynamic dims) are 64-bit 2's-compl
        value &= (1 << 64) - 1
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fields(data: bytes):
    """Yield (field_number, wire_type, value) over a message body."""
    buf = memoryview(data)
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = bytes(buf[pos:pos + ln])
            pos += ln
        elif wtype == 5:  # 32-bit
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _emit(out: bytearray, fnum: int, wtype: int, payload) -> None:
    _write_varint(out, (fnum << 3) | wtype)
    if wtype == 0:
        _write_varint(out, payload)
    elif wtype in (1, 5):  # fixed 64/32-bit: raw bytes, no length prefix
        out.extend(payload)
    else:
        _write_varint(out, len(payload))
        out.extend(payload)


def _packed_or_repeated_ints(wtype: int, val) -> List[int]:
    if wtype == 0:
        return [val]
    out, buf, pos = [], memoryview(val), 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _signed(v: int) -> int:
    """varints store int64 two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


# --------------------------------------------------------------------------
# message classes

@dataclass
class Attribute:
    name: str = ""
    type: int = 0  # 1=FLOAT 2=INT 3=STRING 4=TENSOR 5=GRAPH 6=FLOATS
    #                7=INTS 8=STRINGS (AttributeProto.AttributeType enum)
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional["Tensor"] = None
    g: Optional["Graph"] = None   # subgraph (If/Loop/Scan bodies)
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)

    @property
    def value(self) -> Any:
        return {1: self.f, 2: self.i, 3: self.s.decode("utf-8", "replace"),
                4: self.t, 5: self.g, 6: list(self.floats),
                7: list(self.ints),
                8: [s.decode("utf-8", "replace") for s in self.strings]
                }.get(self.type)

    @staticmethod
    def parse(data: bytes) -> "Attribute":
        a = Attribute()
        for fnum, wtype, val in _fields(data):
            if fnum == 1:
                a.name = val.decode()
            elif fnum == 2:
                a.f = struct.unpack("<f", val)[0]
            elif fnum == 3:
                a.i = _signed(val)
            elif fnum == 4:
                a.s = val
            elif fnum == 5:
                a.t = Tensor.parse(val)
            elif fnum == 6:
                a.g = Graph.parse(val)
            elif fnum == 7:
                a.floats += (list(struct.unpack(f"<{len(val)//4}f", val))
                             if wtype == 2 else [struct.unpack("<f", val)[0]])
            elif fnum == 8:
                a.ints += [_signed(v) for v in _packed_or_repeated_ints(wtype, val)]
            elif fnum == 9:
                a.strings.append(val)
            elif fnum == 20:
                a.type = val
        if a.type == 0:  # infer when writer omitted the type enum
            if a.floats:
                a.type = 6
            elif a.ints:
                a.type = 7
            elif a.strings:
                a.type = 8
            elif a.t is not None:
                a.type = 4
            elif a.g is not None:
                a.type = 5
            elif a.s:
                a.type = 3
        return a

    def encode(self) -> bytes:
        out = bytearray()
        _emit(out, 1, 2, self.name.encode())
        if self.type == 1:
            _emit(out, 2, 5, struct.pack("<f", self.f))
        elif self.type == 2:
            _emit(out, 3, 0, self.i & ((1 << 64) - 1))
        elif self.type == 3:
            _emit(out, 4, 2, self.s)
        elif self.type == 4 and self.t is not None:
            _emit(out, 5, 2, self.t.encode())
        elif self.type == 5 and self.g is not None:
            _emit(out, 6, 2, self.g.encode())
        elif self.type == 6:
            _emit(out, 7, 2, struct.pack(f"<{len(self.floats)}f", *self.floats))
        elif self.type == 7:
            packed = bytearray()
            for v in self.ints:
                _write_varint(packed, v & ((1 << 64) - 1))
            _emit(out, 8, 2, bytes(packed))
        elif self.type == 8:
            for s in self.strings:
                _emit(out, 9, 2, s)
        _emit(out, 20, 0, self.type)
        return bytes(out)


@dataclass
class Tensor:
    name: str = ""
    dims: List[int] = field(default_factory=list)
    data_type: int = 1
    raw: bytes = b""
    values: Optional[np.ndarray] = None

    def array(self) -> np.ndarray:
        if self.values is not None:
            return self.values
        dt = DTYPES.get(self.data_type)
        if dt is None:
            raise ValueError(f"unsupported tensor data_type {self.data_type}")
        arr = np.frombuffer(self.raw, dtype=dt) if self.raw else \
            np.zeros(int(np.prod(self.dims or [0])), dtype=dt)
        return arr.reshape(self.dims).copy()

    @staticmethod
    def parse(data: bytes) -> "Tensor":
        t = Tensor()
        f32, i32, i64, f64 = [], [], [], []
        for fnum, wtype, val in _fields(data):
            if fnum == 1:
                t.dims += [_signed(v) for v in _packed_or_repeated_ints(wtype, val)]
            elif fnum == 2:
                t.data_type = val
            elif fnum == 4:
                f32 += (list(struct.unpack(f"<{len(val)//4}f", val))
                        if wtype == 2 else [struct.unpack("<f", val)[0]])
            elif fnum == 5:
                i32 += [_signed(v) for v in _packed_or_repeated_ints(wtype, val)]
            elif fnum == 7:
                i64 += [_signed(v) for v in _packed_or_repeated_ints(wtype, val)]
            elif fnum == 8:
                t.name = val.decode()
            elif fnum == 9:
                t.raw = val
            elif fnum == 10:
                f64 += (list(struct.unpack(f"<{len(val)//8}d", val))
                        if wtype == 2 else [struct.unpack("<d", val)[0]])
        if not t.raw:
            if f32:
                t.values = np.asarray(f32, np.float32).reshape(t.dims)
            elif i64:
                t.values = np.asarray(i64, np.int64).reshape(t.dims)
            elif i32:
                if t.data_type == 10:  # fp16 in int32_data holds BIT PATTERNS
                    t.values = (np.asarray(i32, dtype=np.uint16)
                                .view(np.float16).reshape(t.dims))
                else:
                    dt = DTYPES.get(t.data_type, np.int32)
                    t.values = np.asarray(i32).astype(dt).reshape(t.dims)
            elif f64:
                t.values = np.asarray(f64, np.float64).reshape(t.dims)
        return t

    @staticmethod
    def from_array(name: str, arr: np.ndarray) -> "Tensor":
        arr = np.ascontiguousarray(arr)
        code = DTYPE_CODES.get(arr.dtype)
        if code is None:
            raise ValueError(f"unsupported dtype {arr.dtype}")
        return Tensor(name=name, dims=list(arr.shape), data_type=code,
                      raw=arr.tobytes())

    def encode(self) -> bytes:
        out = bytearray()
        for d in self.dims:
            _emit(out, 1, 0, d)
        _emit(out, 2, 0, self.data_type)
        _emit(out, 8, 2, self.name.encode())
        raw = self.raw or (self.values.tobytes() if self.values is not None else b"")
        _emit(out, 9, 2, raw)
        return bytes(out)


@dataclass
class Node:
    op_type: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    name: str = ""
    attrs: Dict[str, Attribute] = field(default_factory=dict)
    domain: str = ""              # NodeProto field 7 (e.g. "ai.onnx.ml")

    def attr(self, name: str, default: Any = None) -> Any:
        a = self.attrs.get(name)
        return default if a is None else a.value

    @staticmethod
    def parse(data: bytes) -> "Node":
        n = Node()
        for fnum, _, val in _fields(data):
            if fnum == 1:
                n.inputs.append(val.decode())
            elif fnum == 2:
                n.outputs.append(val.decode())
            elif fnum == 3:
                n.name = val.decode()
            elif fnum == 4:
                n.op_type = val.decode()
            elif fnum == 5:
                a = Attribute.parse(val)
                n.attrs[a.name] = a
            elif fnum == 7:
                n.domain = val.decode()
        return n

    def encode(self) -> bytes:
        out = bytearray()
        for s in self.inputs:
            _emit(out, 1, 2, s.encode())
        for s in self.outputs:
            _emit(out, 2, 2, s.encode())
        _emit(out, 3, 2, self.name.encode())
        _emit(out, 4, 2, self.op_type.encode())
        for a in self.attrs.values():
            _emit(out, 5, 2, a.encode())
        if self.domain:
            _emit(out, 7, 2, self.domain.encode())
        return bytes(out)


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = 1
    shape: List[Any] = field(default_factory=list)  # int or str (dim_param)

    @staticmethod
    def parse(data: bytes) -> "ValueInfo":
        vi = ValueInfo()
        for fnum, _, val in _fields(data):
            if fnum == 1:
                vi.name = val.decode()
            elif fnum == 2:  # TypeProto
                for f2, _, v2 in _fields(val):
                    if f2 == 1:  # tensor_type
                        for f3, _, v3 in _fields(v2):
                            if f3 == 1:
                                vi.elem_type = v3
                            elif f3 == 2:  # shape
                                for f4, _, v4 in _fields(v3):
                                    if f4 == 1:  # dim
                                        dim: Any = -1
                                        for f5, _, v5 in _fields(v4):
                                            if f5 == 1:
                                                dim = _signed(v5)
                                            elif f5 == 2:
                                                dim = v5.decode()
                                        vi.shape.append(dim)
        return vi

    def encode(self) -> bytes:
        shape = bytearray()
        for d in self.shape:
            dim = bytearray()
            if isinstance(d, str):
                _emit(dim, 2, 2, d.encode())
            else:
                _emit(dim, 1, 0, int(d))
            _emit(shape, 1, 2, bytes(dim))
        tt = bytearray()
        _emit(tt, 1, 0, self.elem_type)
        _emit(tt, 2, 2, bytes(shape))
        tp = bytearray()
        _emit(tp, 1, 2, bytes(tt))
        out = bytearray()
        _emit(out, 1, 2, self.name.encode())
        _emit(out, 2, 2, bytes(tp))
        return bytes(out)


@dataclass
class Graph:
    nodes: List[Node] = field(default_factory=list)
    name: str = "graph"
    initializers: Dict[str, Tensor] = field(default_factory=dict)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)

    @staticmethod
    def parse(data: bytes) -> "Graph":
        g = Graph()
        for fnum, _, val in _fields(data):
            if fnum == 1:
                g.nodes.append(Node.parse(val))
            elif fnum == 2:
                g.name = val.decode()
            elif fnum == 5:
                t = Tensor.parse(val)
                g.initializers[t.name] = t
            elif fnum == 11:
                g.inputs.append(ValueInfo.parse(val))
            elif fnum == 12:
                g.outputs.append(ValueInfo.parse(val))
        return g

    def encode(self) -> bytes:
        out = bytearray()
        for n in self.nodes:
            _emit(out, 1, 2, n.encode())
        _emit(out, 2, 2, self.name.encode())
        for t in self.initializers.values():
            _emit(out, 5, 2, t.encode())
        for vi in self.inputs:
            _emit(out, 11, 2, vi.encode())
        for vi in self.outputs:
            _emit(out, 12, 2, vi.encode())
        return bytes(out)


@dataclass
class Model:
    graph: Graph = field(default_factory=Graph)
    ir_version: int = 8
    opset: int = 17
    producer_name: str = ""   # ModelProto field 2 (e.g. "pytorch" — lets
                              # tests prove a fixture came from a third party)
    ml_opset: Optional[int] = None   # ai.onnx.ml domain version, when used

    @staticmethod
    def parse(data: bytes) -> "Model":
        m = Model()
        for fnum, _, val in _fields(data):
            if fnum == 1:
                m.ir_version = val
            elif fnum == 2:
                m.producer_name = bytes(val).decode("utf-8", "replace")
            elif fnum == 7:
                m.graph = Graph.parse(val)
            elif fnum == 8:  # OperatorSetIdProto: (domain, version)
                dom, ver = "", None
                for f2, _, v2 in _fields(val):
                    if f2 == 1:
                        dom = bytes(v2).decode("utf-8", "replace")
                    elif f2 == 2:
                        ver = _signed(v2)
                if ver is not None:
                    # a domain'd entry (ai.onnx.ml) must not clobber the
                    # default-domain opset (onnxmltools graphs carry both)
                    if dom in ("", "ai.onnx"):
                        m.opset = ver
                    elif dom == "ai.onnx.ml":
                        m.ml_opset = ver
        return m

    @staticmethod
    def load(path: str) -> "Model":
        with open(path, "rb") as f:
            return Model.parse(f.read())

    def encode(self) -> bytes:
        out = bytearray()
        _emit(out, 1, 0, self.ir_version)
        opset = bytearray()
        _emit(opset, 1, 2, b"")  # default domain
        _emit(opset, 2, 0, self.opset)
        _emit(out, 8, 2, bytes(opset))
        if self.ml_opset is not None:
            mlset = bytearray()
            _emit(mlset, 1, 2, b"ai.onnx.ml")
            _emit(mlset, 2, 0, self.ml_opset)
            _emit(out, 8, 2, bytes(mlset))
        _emit(out, 7, 2, self.graph.encode())
        return bytes(out)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.encode())
