"""VW-style feature hashing (murmur3-32).

The reference re-implements VW's murmur hash JVM-side for exact parity with the
native learner (vw/.../VowpalWabbitMurmurWithPrefix.scala, and
`VowpalWabbitMurmur.hash` from the vw-jni package). We follow the same hashing
contract so hashed feature indices are VW-compatible:

  - namespace seed  = murmur3_32(utf8(namespace), 0)
  - string feature  = murmur3_32(utf8(name), namespace_seed)
  - integer-looking feature names index directly: int(name) + namespace_seed
    (VW's default `--hash strings` behavior for numeric names)
  - final index     = hash & ((1 << num_bits) - 1)

Host-side: the port's copy of the JAX package's ``vw/hashing.py``. Where the
JAX package hashes batches through its native C++ helper, the port hashes a
batch with murmur3 vectorised over numpy ``uint32`` arrays (one pass per
name length), which gives the same bits.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M32 = 0xFFFFFFFF


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 over ``data`` — the hash VW uses for all features."""
    h = int(seed) & _M32  # plain int — numpy scalars would wrap with warnings
    n = len(data)
    rounded = n & ~3
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * _C1) & _M32
        k = ((k << 15) | (k >> 17)) & _M32
        k = (k * _C2) & _M32
        h ^= k
        h = ((h << 13) | (h >> 19)) & _M32
        h = (h * 5 + 0xE6546B64) & _M32
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _M32
        k = ((k << 15) | (k >> 17)) & _M32
        k = (k * _C2) & _M32
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


@lru_cache(maxsize=4096)
def namespace_hash(namespace: str, hash_seed: int = 0) -> int:
    """Seed for all features inside ``namespace`` (empty namespace → the raw
    hash_seed, VW's --hash_seed)."""
    if not namespace:
        return hash_seed
    return murmur3_32(namespace.encode("utf-8"), hash_seed)


def _int_name(name: str):
    """ASCII-digit integer name, |value| <= 2^40 — matching VW's C parser and
    the native fast path exactly (unicode digits are NOT integers here)."""
    if not name:
        return None
    body = name[1:] if name[0] == "-" else name
    if not body or any(c < "0" or c > "9" for c in body):
        return None
    v = int(name)
    return v if abs(v) <= (1 << 40) else None


@lru_cache(maxsize=1 << 16)
def hash_feature(name: str, ns_seed: int = 0) -> int:
    """Un-masked feature hash. Integer-looking names index directly (VW default)."""
    v = _int_name(name)
    if v is not None:
        return (v + int(ns_seed)) & _M32
    return murmur3_32(name.encode("utf-8"), ns_seed)


def interaction_hash(h1: int, h2: int) -> int:
    """Quadratic-interaction index combine (VW: h1 * FNV_prime XOR h2)."""
    return ((h1 * 0x01000193) ^ h2) & _M32


def murmur3_32_batch(datas, seed: int = 0) -> np.ndarray:
    """:func:`murmur3_32` of every byte string of ``datas`` at one seed, as
    a ``uint32`` array: the names of each byte length hashed together, each
    step on a numpy ``uint32`` column (wrapping arithmetic)."""
    out = np.empty(len(datas), np.uint32)
    by_len: dict = {}
    for i, d in enumerate(datas):
        by_len.setdefault(len(d), []).append(i)
    c1, c2 = np.uint32(_C1), np.uint32(_C2)

    def mix(k):
        k = k * c1
        k = (k << np.uint32(15)) | (k >> np.uint32(17))
        return k * c2

    for n, rows in by_len.items():
        m = len(rows)
        raw = np.frombuffer(b"".join(datas[i] for i in rows),
                            np.uint8).reshape(m, n)
        h = np.full(m, int(seed) & _M32, np.uint32)
        rounded = n & ~3
        if rounded:
            blocks = np.ascontiguousarray(raw[:, :rounded]).view("<u4")
            for j in range(rounded // 4):
                h ^= mix(blocks[:, j].astype(np.uint32))
                h = (h << np.uint32(13)) | (h >> np.uint32(19))
                h = h * np.uint32(5) + np.uint32(0xE6546B64)
        tail = raw[:, rounded:].astype(np.uint32)
        if tail.shape[1]:
            k = np.zeros(m, np.uint32)
            for j in range(tail.shape[1] - 1, -1, -1):
                k ^= tail[:, j] << np.uint32(8 * j)
            h ^= mix(k)
        h ^= np.uint32(n & _M32)
        h ^= h >> np.uint32(16)
        h = h * np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
        out[rows] = h
    return out


def hash_strings(names, ns_seed: int = 0, num_bits: Optional[int] = None) -> np.ndarray:
    """Vectorized hashing of a sequence of feature names — the numpy
    murmur3 over a batch (:func:`murmur3_32_batch`), the Python loop for a
    few names. Both follow the VW contract above bit-for-bit."""
    names = [str(s) for s in names]
    if len(names) >= 64:  # the per-length passes only pay off on real batches
        out = np.empty(len(names), np.int64)
        ints = [_int_name(s) for s in names]
        hashed = [i for i, v in enumerate(ints) if v is None]
        for i, v in enumerate(ints):
            if v is not None:
                out[i] = (v + int(ns_seed)) & _M32
        if hashed:
            out[hashed] = murmur3_32_batch(
                [names[i].encode("utf-8") for i in hashed], ns_seed)
    else:
        out = np.fromiter((hash_feature(s, ns_seed) for s in names),
                          dtype=np.int64, count=len(names))
    if num_bits is not None:
        out &= (1 << num_bits) - 1
    return out
