"""flax's msgpack checkpoint format, without the ``msgpack`` package.

Counterpart of ``flax.serialization``: the state-dict conversion
(``to_state_dict``/``from_state_dict``) and ``to_bytes``/``from_bytes``
over a small encoder and decoder of the msgpack spec written here (maps,
str, int, float, bool, nil, bin, arrays and ext). The bytes are flax's:

* a dict keeps its key order, a list or tuple becomes ``{"0": ..., "1":
  ...}``, a namedtuple a dict keyed by its field names;
* an array leaf is ext type 1 holding ``packb((shape, dtype name,
  C-order bytes))``, a numpy scalar ext type 3 of the same, a complex
  scalar ext type 2 of ``(real, imag)``; ints take msgpack's smallest
  encoding, floats are doubles, shapes are packed as arrays;
* an array above ``MAX_CHUNK_SIZE`` bytes becomes ``{"__msgpack_chunked_
  array__": True, "shape": {...}, "chunks": {...}}`` of flat chunks.

Leaves may be numpy arrays or torch tensors. A ``bfloat16`` leaf is a
``torch.bfloat16`` tensor (written and read as its 2-byte pattern): numpy
has no bfloat16 without ``ml_dtypes``. Decoded arrays are numpy (writable
copies) except ``bfloat16`` ones, which are CPU tensors.

``from_bytes(target, data)`` checks names as flax does (a key of the target
missing from the data raises), and also each array leaf's shape and dtype
against the target's leaf, which flax does not.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}


# --- state dicts ------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_state_dict(target):
    """flax's state dict of ``target``: dicts, lists, tuples and
    namedtuples become dicts with string keys; other values are leaves."""
    if _is_namedtuple(target):
        return {k: to_state_dict(getattr(target, k)) for k in target._fields}
    if isinstance(target, dict):
        keys = {str(k) for k in target}
        if len(keys) != len(target):
            raise ValueError("dict keys do not have a unique string "
                             f"representation: {sorted(keys)}")
        return {str(k): to_state_dict(v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(target)}
    return target


def _leaf_like(target, value, path: str):
    """``value`` as the kind of ``target`` (a torch tensor on its device, a
    CPU tensor for a target on the meta device, or a numpy array), checked
    against its shape and dtype."""
    if isinstance(target, torch.Tensor):
        got = value if isinstance(value, torch.Tensor) else \
            torch.from_numpy(np.asarray(value))
        if tuple(got.shape) != tuple(target.shape) or got.dtype != \
                target.dtype:
            raise ValueError(f"leaf {path}: saved {got.dtype} "
                             f"{tuple(got.shape)}, target {target.dtype} "
                             f"{tuple(target.shape)}")
        return got if target.device.type == "meta" else got.to(target.device)
    if isinstance(target, (np.ndarray, np.generic)):
        got = value.numpy() if isinstance(value, torch.Tensor) else \
            np.asarray(value)
        if got.shape != np.shape(target) or got.dtype != target.dtype:
            raise ValueError(f"leaf {path}: saved {got.dtype} {got.shape}, "
                             f"target {target.dtype} {np.shape(target)}")
        return got if isinstance(target, np.ndarray) else got[()]
    return value


def from_state_dict(target, state, name: str = "."):
    """A copy of ``target``'s structure holding ``state``'s values (flax's
    ``from_state_dict``, with each array leaf checked against the
    target's shape and dtype)."""
    def sub(target_child, key: str):
        if not isinstance(state, dict) or key not in state:
            have = sorted(state) if isinstance(state, dict) else type(state)
            raise ValueError(f"the state dict at {name} lacks key {key!r} "
                             f"of the target (it holds {have})")
        return from_state_dict(target_child, state[key],
                               f"{name.rstrip('/')}/{key}")

    if _is_namedtuple(target):
        if not isinstance(state, dict) or set(state) != set(target._fields):
            raise ValueError(f"the field names at {name} do not match: "
                             f"saved {sorted(state) if isinstance(state, dict) else state!r}, "
                             f"target {list(target._fields)}")
        return type(target)(**{k: sub(getattr(target, k), k)
                                for k in target._fields})
    if isinstance(target, dict):
        return {k: sub(v, str(k)) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(state, dict) or len(state) != len(target):
            raise ValueError(f"the sequence at {name} has {len(target)} "
                             f"items, the state dict {len(state) if isinstance(state, dict) else state!r}")
        out = [sub(v, str(i)) for i, v in enumerate(target)]
        return out if isinstance(target, list) else tuple(out)
    return _leaf_like(target, state, name)


# --- array leaves -----------------------------------------------------------

def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _array_parts(x):
    """(shape, dtype name, C-order bytes) of a numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        if t.dtype not in _TORCH_NAMES:
            raise ValueError(f"cannot serialize a {t.dtype} tensor")
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return tuple(t.shape), _TORCH_NAMES[t.dtype], raw.numpy().tobytes()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return x.shape, x.dtype.name, x.tobytes("C")


def _array_from_parts(shape, dtype_name: str, buf: bytes):
    if dtype_name == "bfloat16":
        t = torch.frombuffer(bytearray(buf), dtype=torch.int16) if buf \
            else torch.empty(0, dtype=torch.int16)
        return t.view(torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(
        tuple(shape)).copy()


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else \
        x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i: i + size] for j, i in
                       enumerate(range(0, n, size))}}


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    parts = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts).reshape(shape)
    return np.concatenate(parts).reshape(shape)


def _chunk_in_place(d):
    if isinstance(d, dict):
        for k, v in d.items():
            if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE:
                d[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_in_place(v)
    elif _is_array(d) and _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def _unchunk_in_place(d):
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk_in_place(v)
    return d


# --- the msgpack encoder ----------------------------------------------------

class _Ext:
    __slots__ = ("code", "data")

    def __init__(self, code: int, data: bytes):
        self.code, self.data = code, data


def _header(out: bytearray, n: int, fix_base: int, fix_max: int,
            wide: tuple) -> None:
    """A length header: the fix form up to ``fix_max``, else the first of
    ``wide``'s (marker, struct code, limit) that holds ``n``."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for marker, code, limit in wide:
        if n <= limit:
            out += struct.pack(">B" + code, marker, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


_STR = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF))
_BIN = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF))
_ARR = ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF))
_MAP = ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack("b" if v < 0 else "B", v)
    elif 0 < v <= 0xFF:
        out += struct.pack("BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0 < v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < 0:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0 < v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < 0:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0 < v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < 0:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError(f"integer {v} out of msgpack's range")


def _pack_ndarray(x) -> bytes:
    shape, name, buf = _array_parts(x)
    out = bytearray()
    _pack(out, [list(shape), name, buf], lambda v: v)
    return bytes(out)


def _ext_of(x):
    """flax's ext packing of a leaf msgpack has no type for."""
    if _is_array(x):
        return _Ext(EXT_NDARRAY, _pack_ndarray(x))
    if isinstance(x, np.generic):
        return _Ext(EXT_NPSCALAR, _pack_ndarray(np.asarray(x)))
    if isinstance(x, complex):
        out = bytearray()
        _pack(out, [x.real, x.imag], lambda v: v)
        return _Ext(EXT_COMPLEX, bytes(out))
    raise TypeError(f"cannot serialize {type(x).__name__} {x!r}")


def _pack(out: bytearray, obj, default) -> None:
    """msgpack-python's encoding of ``obj`` with exact type checks (its
    ``strict_types``: only a list packs as an array, so tuples must have
    been made dicts or lists first); anything else goes through
    ``default``."""
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t in (bytes, bytearray):
        _header(out, len(obj), None, -1, _BIN)
        out += obj
    elif t is str:
        b = obj.encode("utf-8")
        _header(out, len(b), 0xA0, 0x1F, _STR)
        out += b
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is _Ext:
        n = len(obj.data)
        if n in _FIXEXT:
            out.append(_FIXEXT[n])
        else:
            _header(out, n, None, -1, ((0xC7, "B", 0xFF),
                                       (0xC8, "H", 0xFFFF),
                                       (0xC9, "I", 0xFFFFFFFF)))
        out += struct.pack("b", obj.code)
        out += obj.data
    elif t is list:
        _header(out, len(obj), 0x90, 0x0F, _ARR)
        for v in obj:
            _pack(out, v, default)
    elif t is dict:
        _header(out, len(obj), 0x80, 0x0F, _MAP)
        for k, v in obj.items():
            _pack(out, k, default)
            _pack(out, v, default)
    else:
        conv = default(obj)
        if conv is obj:
            raise TypeError(f"cannot serialize {t.__name__} {obj!r}")
        _pack(out, conv, default)


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (dicts, lists, str, bytes, int, float,
    bool, None, and array or scalar leaves as flax's ext types)."""
    out = bytearray()
    _pack(out, obj, _ext_of)
    return bytes(out)


# --- the msgpack decoder ----------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        b = self.data[self.pos: self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("arr", ">H"), 0xDD: ("arr", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
_NUMS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
         0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


def _unpack(r: _Reader, ext_hook, raw: bool):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif 0x90 <= b <= 0x9F:
        kind, n = "arr", b & 0x0F
    elif 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif b in _FIXED:
        kind, fmt = _FIXED[b]
        n = r.unpack(fmt)
    elif b in _FIXEXT_LEN:
        kind, n = "ext", _FIXEXT_LEN[b]
    elif b in _NUMS:
        return r.unpack(_NUMS[b])
    elif b == 0xC0:
        return None
    elif b in (0xC2, 0xC3):
        return b == 0xC3
    else:
        raise ValueError(f"msgpack byte 0x{b:02x} is not supported")
    if kind == "bin":
        return r.take(n)
    if kind == "str":
        s = r.take(n)
        return s if raw else s.decode("utf-8")
    if kind == "arr":
        return [_unpack(r, ext_hook, raw) for _ in range(n)]
    if kind == "map":
        out = {}
        for _ in range(n):
            k = _unpack(r, ext_hook, raw)
            out[k] = _unpack(r, ext_hook, raw)
        return out
    code = r.unpack("b")
    return ext_hook(code, r.take(n))


def unpackb(data: bytes, ext_hook=None, raw: bool = False):
    """The value of one msgpack object, which must fill ``data``."""
    r = _Reader(data)
    hook = ext_hook or (lambda code, d: _Ext(code, d))
    out = _unpack(r, hook, raw)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of msgpack data "
                         "after the object")
    return out


def _ndarray_from_bytes(data: bytes):
    shape, name, buf = unpackb(data, raw=True)
    return _array_from_parts(shape, name.decode("ascii"), buf)


def _ext_unpack(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_NPSCALAR:
        a = _ndarray_from_bytes(data)
        return a[()] if isinstance(a, np.ndarray) else a.reshape(())
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    return _Ext(code, data)


# --- the API ----------------------------------------------------------------

def msgpack_serialize(pytree: Any) -> bytes:
    """flax's ``msgpack_serialize``: ``pytree`` (dicts, lists and leaves)
    with arrays above ``MAX_CHUNK_SIZE`` bytes chunked."""
    return packb(_chunk_in_place(_copy_dicts(pytree)))


def _copy_dicts(d):
    return {k: _copy_dicts(v) for k, v in d.items()} if isinstance(d, dict) \
        else d


def msgpack_restore(data: bytes) -> Any:
    """flax's ``msgpack_restore``: the tree of ``msgpack_serialize``."""
    return _unchunk_in_place(unpackb(data, ext_hook=_ext_unpack))


def to_bytes(target: Any) -> bytes:
    """``flax.serialization.to_bytes``: the msgpack bytes of ``target``'s
    state dict."""
    return packb(_chunk_in_place(to_state_dict(target)))


def from_bytes(target: Any, data: bytes) -> Any:
    """``flax.serialization.from_bytes``: ``target``'s structure filled
    from ``data``; names, shapes and dtypes are checked."""
    return from_state_dict(target, msgpack_restore(data))
