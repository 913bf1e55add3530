"""Native host-helper library: build, load, and ctypes bindings.

The port's copy of the JAX package's ``native/__init__.py`` with its own
copy of the C++ source (``native/src/synapseml_native.cpp``). The library is
a host helper, not a device kernel: it hashes and tokenizes strings and
parses numeric CSV on the CPU, for the featurizers and VW's hashing.

The NativeLoader analog (reference: core/.../core/env/NativeLoader.java
extracts .so files from the jar and System.load()s them per executor;
lightgbm/.../LightGBMUtils.scala:31-34). Here the .so is compiled from the
source with the host ``g++`` at first use, into the checkout's
``build/synapseml_tpu_torch/`` (where the CUDA kernels are built too, never
beside the source), loaded via ctypes, and every binding has a pure-Python
fallback — ``available()`` says which path is active. The library's file
name carries a digest of its source and flags, so an edited source is
rebuilt and a stale library is never loaded; a build goes to a temporary
file first, so processes that build at once never load a half-written one.

Bindings:
  murmur3_32_batch(names, seed(s), vw_numeric_names, mask) -> uint32[n]
  hash_tf(docs, num_features, seed, min_len, binary) -> float32[n, dim]
  read_numeric_csv(path, has_header) -> float32[rows, cols]
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Union

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "src", "synapseml_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "synapseml_tpu_torch")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """Where the library for the current source and flags is (or will be)
    built."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsynapseml_native_{digest}.so")


def _build(out: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sml_murmur3_32.restype = ctypes.c_uint32
    lib.sml_murmur3_32.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_uint32]
    lib.sml_hash_batch.restype = None
    lib.sml_hash_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p]
    lib.sml_hash_batch_seeded.restype = None
    lib.sml_hash_batch_seeded.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p]
    lib.sml_hash_tf.restype = None
    lib.sml_hash_tf.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.csv_dims.argtypes = [ctypes.c_char_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int64),
                             ctypes.POINTER(ctypes.c_int64)]
    lib.csv_dims.restype = ctypes.c_int
    lib.csv_read_f32.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_float)]
    lib.csv_read_f32.restype = ctypes.c_int64
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
        except OSError:
            return None
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            _lib = _bind(ctypes.CDLL(so))
        except (OSError, AttributeError):
            return None
        return _lib


def available() -> bool:
    return _load() is not None


def _pack(strings: Sequence[str]):
    """Concatenate utf-8 names + int64 offsets (n+1)."""
    encoded = [s.encode("utf-8") for s in strings]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    buf = b"".join(encoded)
    return np.frombuffer(buf, dtype=np.uint8), offsets


def murmur3_32(data: bytes, seed: int = 0) -> int:
    lib = _load()
    if lib is None:
        from ..vw.hashing import murmur3_32 as py_hash

        return py_hash(data, seed)
    return int(lib.sml_murmur3_32(data, len(data), seed & 0xFFFFFFFF))


def murmur3_32_batch(names: Sequence[str],
                     seed: Union[int, np.ndarray] = 0,
                     vw_numeric_names: bool = True,
                     mask: int = 0) -> Optional[np.ndarray]:
    """Hash a batch of names; ``seed`` may be a scalar or per-name uint32
    array. Returns None when the native library is unavailable (callers keep
    their Python path)."""
    lib = _load()
    if lib is None:
        return None
    buf, offsets = _pack(names)
    n = len(names)
    out = np.empty(n, dtype=np.uint32)
    buf_p = buf.ctypes.data_as(ctypes.c_void_p) if buf.size else None
    if isinstance(seed, (int, np.integer)):
        lib.sml_hash_batch(buf_p, offsets.ctypes.data_as(ctypes.c_void_p),
                           n, int(seed) & 0xFFFFFFFF,
                           int(vw_numeric_names), mask & 0xFFFFFFFF,
                           out.ctypes.data_as(ctypes.c_void_p))
    else:
        seeds = np.ascontiguousarray(seed, dtype=np.uint32)
        lib.sml_hash_batch_seeded(
            buf_p, offsets.ctypes.data_as(ctypes.c_void_p), n,
            seeds.ctypes.data_as(ctypes.c_void_p), int(vw_numeric_names),
            mask & 0xFFFFFFFF, out.ctypes.data_as(ctypes.c_void_p))
    return out


def hash_tf(docs: Sequence[str], num_features: int, seed: int = 0,
            min_len: int = 1, binary: bool = False) -> Optional[np.ndarray]:
    """Tokenize (non-alnum split, ascii lowercase) + hashing-TF each document
    into a [n, num_features] dense matrix; num_features must be a power of 2.
    Returns None when unavailable."""
    lib = _load()
    if lib is None or num_features & (num_features - 1):
        return None
    buf, offsets = _pack(docs)
    out = np.zeros((len(docs), num_features), dtype=np.float32)
    buf_p = buf.ctypes.data_as(ctypes.c_void_p) if buf.size else None
    lib.sml_hash_tf(buf_p, offsets.ctypes.data_as(ctypes.c_void_p),
                    len(docs), seed & 0xFFFFFFFF, (num_features - 1),
                    min_len, int(binary),
                    out.ctypes.data_as(ctypes.c_void_p))
    return out


def read_numeric_csv(path: str, has_header: bool = True):
    """Dense float32 matrix from a numeric CSV via the C++ reader (empty /
    non-numeric fields -> NaN, LightGBM's missing convention); None when the
    native library is unavailable (callers fall back to numpy). The native
    data-plane analog of the reference's chunked dataset aggregation
    (dataset/DatasetAggregator.scala:117-589)."""
    lib = _load()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.csv_dims(path.encode(), int(has_header),
                      ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0 or rows.value <= 0 or cols.value <= 0:
        return None
    out = np.empty((rows.value, cols.value), np.float32)
    got = lib.csv_read_f32(path.encode(), int(has_header), rows.value,
                           cols.value,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        return None
    return out[:got]
