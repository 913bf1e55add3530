"""The threefry-2x32 counter-based random stream, bit for bit.

The JAX package draws every per-iteration sample (bagging, GOSS, feature
fractions, per-node feature masks) from ``jax.random`` keys with the
default threefry implementation, under ``jax_threefry_partitionable``
(the default since JAX 0.5). This module computes the same bits with
plain integer operations, so a fit samples the same rows and features as
the JAX package on any device:

* a key is two 32-bit words: a tuple of two Python ints for one key, or a
  ``(..., 2)`` int64 tensor for a batch of keys;
* ``prng_key(seed)`` is ``PRNGKey(seed)`` with 64-bit mode off: the words
  ``(0, seed mod 2^32)``;
* ``fold_in(key, data)`` hashes the counter pair ``(0, data)``;
* ``split(key, num)`` hashes the counters ``(i >> 32, i & 0xFFFFFFFF)``
  for ``i < num`` (the partitionable, fold-like split);
* ``random_bits(key, n)`` is the XOR of the two output words over the
  counters of ``range(n)``; ``uniform`` keeps its top 23 bits as the
  mantissa of a float32 in [1, 2) and subtracts 1;
* ``uniform_range`` is ``uniform(key, shape, minval=lo, maxval=hi)``:
  ``max(lo, u * (hi - lo) + lo)`` with one float32 rounding (XLA's fma);
  ``normal`` is ``sqrt(2) * erfinv`` of a uniform draw on
  ``(nextafter(-1, 0), 1)``
  (torch's ``erfinv`` against XLA's polynomial: a few ulps apart);
  ``categorical`` is the Gumbel-max draw ``argmax(logits - log(-log(u)))``
  of ``jax.random.categorical`` (``u`` uniform on ``(tiny, 1)``);
* ``permutation(key, n)`` sorts ``arange(n)`` stably by fresh 32-bit keys
  for ``ceil(3 ln n / ln(2^32 - 1))`` rounds, splitting the key each round.

One key's derivations (``fold_in`` of an int, ``split``) are a few hundred
integer operations and run on the host in Python ints; the draws run on
the device they are asked for, as int64 tensors masked to 32 bits after
each add, so the same code is exact on the CPU and on the card. A batch of
keys (``fold_in`` of a tensor of data) draws in one call: every node mask
of a tree at once.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Union[Tuple[int, int], torch.Tensor]


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry_2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``x1``, ``x2``
    under key words ``k1``, ``k2``: Python ints or int64 tensors of 32-bit
    values, broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` (64-bit mode off)."""
    return 0, int(seed) & MASK


def _words(key: Key):
    if isinstance(key, torch.Tensor):
        return key[..., 0], key[..., 1]
    return int(key[0]), int(key[1])


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``. An int ``data`` folds into one key (host
    ints) or each key of a batch; an int tensor ``data`` gives a batch of
    keys (..., 2) on its device."""
    k1, k2 = _words(key)
    if isinstance(data, torch.Tensor):
        y1, y2 = threefry_2x32(k1, k2, torch.zeros_like(data), data & MASK)
        return torch.stack([y1, y2], dim=-1)
    y1, y2 = threefry_2x32(k1, k2, 0, int(data) & MASK)
    if isinstance(y1, torch.Tensor):
        return torch.stack([y1, y2], dim=-1)
    return y1, y2


def split(key: Tuple[int, int], num: int = 2) -> list:
    """``jax.random.split`` of one key: ``num`` keys."""
    k1, k2 = _words(key)
    return [threefry_2x32(k1, k2, i >> 32, i & MASK) for i in range(num)]


def random_bits(key: Key, n: int, device=None) -> torch.Tensor:
    """32-bit random words, (..., n) int64 in [0, 2^32), on ``device``
    (a batch of keys: theirs)."""
    k1, k2 = _words(key)
    if isinstance(k1, torch.Tensor):
        device, k1, k2 = k1.device, k1[..., None], k2[..., None]
    i = torch.arange(n, dtype=torch.int64, device=device)
    y1, y2 = threefry_2x32(k1, k2, i >> 32, i & MASK)
    return y1 ^ y2


def uniform(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: float32 in [0, 1), (..., n)."""
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform_range(key: Tuple[int, int], shape, minval: float,
                  maxval: float, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    shape = tuple(int(s) for s in shape)
    u = uniform(key, math.prod(shape), device).reshape(shape)
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    # XLA fuses the scale and shift into one float32 fma: the float64
    # product is exact and the sum rounds once more
    out = (u.double() * float(span) + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def normal(key: Tuple[int, int], shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform_range(key, shape, lo, 1.0, device)
    return np.float32(np.sqrt(2.0)).item() * torch.erfinv(u)


def categorical(key: Tuple[int, int], logits: torch.Tensor,
                shape) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1, shape)`` for 2-D
    float32 ``logits`` (batch, classes) and ``shape`` ending in batch: one
    sample per leading index, int64."""
    shape = tuple(int(s) for s in shape)
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform_range(key, shape + (logits.shape[-1],), tiny, 1.0,
                      logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=-1)


def permutation(key: Tuple[int, int], n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: (n,) int64 on ``device``."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, n, device), stable=True).indices
        x = x[order]
    return x
