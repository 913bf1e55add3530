"""Maximum-inner-product search indexes.

Reference behavior: nn/BallTree.scala — ``findMaximumInnerProducts(query, k)``
returns the k keys with largest <query, key>, as (index, distance=inner product)
pairs; ConditionalBallTree additionally restricts candidates to keys whose label
is in a per-query ``conditioner`` set (nn/ConditionalKNN.scala:67-68).

The port's counterpart of the JAX package's ``nn/balltree.py``. The hot path
is a dense product ``Q @ K.T`` on the tree's device followed by
``ops.topk.top_k`` (``jax.lax.top_k``'s order: ties to the lower key index,
so a conditioned query with fewer admissible keys than k lists its −inf
entries in index order) — brute force is exact, and beats a pointer chase on
the card for any corpus that fits in its memory. The keys are held on the
device once; a query batch whose score matrix would pass ``SCORE_BYTES`` is
split into chunks of queries (each query's answer unchanged). For large corpora a two-level
*ball index* prunes: keys are grouped into balls (split by the
farthest-pair heuristic the reference's tree uses, but only to a fixed block
depth so shapes stay static); each ball stores center and radius; a query
computes the Cauchy-Schwarz upper bound  <q, c> + |q| * r  per ball, keeps the
top blocks, and runs the exact matmul on the gathered subset. Conditioning is a
mask added to the score matrix before top-k (no reverse-index pointer walk).
"""

from __future__ import annotations

import pickle
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..ops.topk import top_k

# the most bytes one chunk's float32 [queries, keys] score matrix may take
SCORE_BYTES = 2 << 30


def _topk_scores(q: np.ndarray, keys: torch.Tensor,
                 mask: Optional[np.ndarray], k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``top_k(Q @ K.T)`` on ``keys``' device, inadmissible keys (``mask``
    False) at −inf: (scores, indices) as numpy, the queries taken in
    chunks whose score matrix fits ``SCORE_BYTES``."""
    dev = keys.device
    rows = max(1, SCORE_BYTES // (4 * max(keys.shape[0], 1)))
    vals, idx = [], []
    with torch.no_grad():
        for start in range(0, q.shape[0], rows):
            s = torch.as_tensor(q[start:start + rows], device=dev) @ keys.T
            if mask is not None:
                m = torch.as_tensor(mask[start:start + rows], device=dev)
                s = torch.where(m, s, float("-inf"))
            v, i = top_k(s, k)
            del s
            vals.append(v.cpu().numpy())
            idx.append(i.cpu().numpy())
    if len(vals) == 1:
        return vals[0], idx[0]
    return np.concatenate(vals), np.concatenate(idx)


class BestMatch(tuple):
    """(index, distance) with attribute access, mirroring nn/BallTree.scala BestMatch."""

    __slots__ = ()

    def __new__(cls, index: int, distance: float):
        return tuple.__new__(cls, (int(index), float(distance)))

    @property
    def index(self) -> int:
        return self[0]

    @property
    def distance(self) -> float:
        return self[1]


def _split_blocks(keys: np.ndarray, leaf_size: int) -> List[np.ndarray]:
    """Recursively split key indices by the farthest-pair heuristic until every
    block has <= max(leaf_size, sqrt(n)) points. Returns index blocks."""
    n = keys.shape[0]
    target = max(leaf_size, int(np.sqrt(n)))
    blocks: List[np.ndarray] = []
    stack = [np.arange(n)]
    while stack:
        idx = stack.pop()
        if idx.size <= target:
            blocks.append(idx)
            continue
        pts = keys[idx]
        mean = pts.mean(axis=0)
        # pivot1 = farthest from mean; pivot2 = farthest from pivot1
        d0 = ((pts - mean) ** 2).sum(axis=1)
        p1 = pts[int(np.argmax(d0))]
        d1 = ((pts - p1) ** 2).sum(axis=1)
        p2 = pts[int(np.argmax(d1))]
        d2 = ((pts - p2) ** 2).sum(axis=1)
        left = d1 <= d2
        if left.all() or (~left).all():  # degenerate (duplicate points)
            half = idx.size // 2
            stack.append(idx[:half])
            stack.append(idx[half:])
        else:
            stack.append(idx[left])
            stack.append(idx[~left])
    return blocks


class BallTree:
    """Exact max-inner-product index over a fixed key matrix.

    API parity with nn/BallTree.scala: ``keys`` (vectors), ``values`` (payload
    returned per match), ``leaf_size``, ``find_maximum_inner_products``.
    Batched queries go through :meth:`query_batch`, on ``device`` (the
    keys are copied there once; :meth:`to` moves them).
    """

    def __init__(self, keys, values: Optional[Sequence[Any]] = None,
                 leaf_size: int = 50, device=DEFAULT_DEVICE):
        self.keys = np.ascontiguousarray(np.asarray(keys, dtype=np.float32))
        if self.keys.ndim != 2:
            raise ValueError("keys must be [n, dim]")
        self.values = (list(values) if values is not None
                       else list(range(self.keys.shape[0])))
        if len(self.values) != self.keys.shape[0]:
            raise ValueError("values length must match number of keys")
        self.leaf_size = int(leaf_size)
        self.device = str(resolve_device(device))
        self._build_index()

    # --- device ---------------------------------------------------------
    def to(self, device) -> "BallTree":
        """Answer queries on ``device`` from now on (returns self)."""
        device = str(resolve_device(device))
        if device != self.device:
            self.device = device
            self.__dict__.pop("_keys_dev", None)
        return self

    def _device_keys(self) -> torch.Tensor:
        keys = self.__dict__.get("_keys_dev")
        if keys is None:
            keys = torch.as_tensor(np.require(self.keys, requirements="W"),
                                   device=resolve_device(self.device))
            self._keys_dev = keys
        return keys

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_keys_dev", None)       # device tensors stay in-process
        state.pop("_codes", None)          # a cache, rebuilt on use
        return state

    def __setstate__(self, state):
        # a tree the JAX package pickled has no device: the default's
        state.setdefault("device", DEFAULT_DEVICE)
        self.__dict__.update(state)

    # --- index build ----------------------------------------------------
    def _build_index(self) -> None:
        blocks = _split_blocks(self.keys, self.leaf_size)
        self._block_of = np.empty(self.keys.shape[0], dtype=np.int32)
        centers, radii = [], []
        for b, idx in enumerate(blocks):
            self._block_of[idx] = b
            pts = self.keys[idx]
            c = pts.mean(axis=0)
            centers.append(c)
            radii.append(np.sqrt(((pts - c) ** 2).sum(axis=1).max()))
        self._centers = np.stack(centers).astype(np.float32)
        self._radii = np.asarray(radii, dtype=np.float32)
        self._blocks = blocks

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    # --- queries --------------------------------------------------------
    def query_batch(self, queries, k: int = 1,
                    mask: Optional[np.ndarray] = None,
                    prune: Optional[bool] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k inner products for a [q, dim] query batch.

        Returns (indices [q, k], scores [q, k]). ``mask`` is an optional
        [q, n] boolean of admissible keys (the conditioner). ``prune=None``
        auto-selects ball-pruning for corpora above ~64k keys.
        """
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        n = self.keys.shape[0]
        k = min(int(k), n)
        if prune is None:
            prune = mask is None and n >= 65536 and self.num_blocks > 8
        if prune and mask is None:  # mask requires the full score matrix
            return self._query_pruned(q, k)

        scores, idx = _topk_scores(q, self._device_keys(), mask, k)
        return idx, scores

    def _query_pruned(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact two-pass search. Pass 1: top-k over the blocks with the best
        Cauchy-Schwarz upper bound  <q,c> + |q|·r  (a candidate budget's worth).
        Pass 2: the kth score from pass 1 is a per-query lower bound; any block
        whose upper bound beats it for some query might still hold a true
        neighbor, so the union is re-searched. Since the bound is sound, the
        result equals brute force. The bounds and the block choice are host
        numpy (the candidate list, its order included, is the JAX
        package's); the two searches run on the device, over the candidate
        keys gathered there."""
        qn = np.linalg.norm(q, axis=1, keepdims=True)
        ub = q @ self._centers.T + qn * self._radii[None, :]  # [q, B]
        want = max(4096, 4 * k)
        order = np.argsort(-ub.max(axis=0))
        sizes = np.asarray([b.size for b in self._blocks])
        csum = np.cumsum(sizes[order])
        nb = int(np.searchsorted(csum, want) + 1)
        first = order[:nb]

        keys = self._device_keys()

        def _topk_subset(block_ids):
            cand = np.concatenate([self._blocks[i] for i in block_ids])
            sub = keys[torch.as_tensor(cand, device=keys.device)]
            scores, local = _topk_scores(q, sub, None, min(k, cand.size))
            return cand, local, scores

        cand, local, scores = _topk_subset(first)
        thresh = scores[:, -1]  # per-query kth best so far
        rest = order[nb:]
        needed = rest[(ub[:, rest] >= thresh[:, None]).any(axis=0)]
        if needed.size:
            cand, local, scores = _topk_subset(np.concatenate([first, needed]))
        return cand[local], scores

    def find_maximum_inner_products(self, query, k: int = 1) -> List[BestMatch]:
        """Single-query API, parity with BallTree.scala:146-152."""
        idx, scores = self.query_batch(np.asarray(query)[None, :], k)
        return [BestMatch(i, s) for i, s in zip(idx[0], scores[0])]

    # camelCase alias matching the reference method name
    findMaximumInnerProducts = find_maximum_inner_products

    # --- persistence (BallTree is a ComplexParam in the reference) ------
    def save(self, filename: str) -> None:
        with open(filename, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(filename: str) -> "BallTree":
        with open(filename, "rb") as f:
            return pickle.load(f)

    def __repr__(self):
        return (f"{type(self).__name__}(keys={self.keys.shape}, "
                f"blocks={self.num_blocks}, leaf_size={self.leaf_size})")


class ConditionalBallTree(BallTree):
    """BallTree whose keys carry labels; queries restrict candidates to a
    conditioner label set (reference: nn/BallTree.scala ConditionalBallTree +
    ReverseIndex). Here the condition is a vectorized mask over the score
    matrix rather than a node-subset tree walk."""

    def __init__(self, keys, labels: Sequence[Any],
                 values: Optional[Sequence[Any]] = None, leaf_size: int = 50,
                 device=DEFAULT_DEVICE):
        super().__init__(keys, values, leaf_size, device)
        if len(labels) != self.keys.shape[0]:
            raise ValueError("labels length must match number of keys")
        self.labels = list(labels)
        self._label_arr = np.asarray(self.labels)

    def _label_codes(self):
        """(distinct labels, each key's index among them), computed once;
        None when the labels do not sort."""
        if "_codes" not in self.__dict__:
            try:
                self._codes = np.unique(self._label_arr, return_inverse=True)
            except TypeError:
                self._codes = None
        return self._codes

    def conditioner_mask(self, conditioners: Sequence[Sequence[Any]]) -> np.ndarray:
        """[q, n] admissibility mask from per-query label sets: each set is
        matched against the distinct labels, then spread to the keys (the
        same mask as matching every key's label)."""
        codes = self._label_codes()
        if codes is None:
            masks = np.zeros((len(conditioners), self.keys.shape[0]),
                             dtype=bool)
            for i, cond in enumerate(conditioners):
                masks[i] = np.isin(self._label_arr, np.asarray(list(cond)))
            return masks
        uniq, inverse = codes
        lut = np.zeros((len(conditioners), len(uniq)), dtype=bool)
        for i, cond in enumerate(conditioners):
            lut[i] = np.isin(uniq, np.asarray(list(cond)))
        return lut[:, inverse.reshape(-1)]

    def query_batch_conditional(self, queries, conditioners, k: int = 1):
        return self.query_batch(queries, k, mask=self.conditioner_mask(conditioners))

    def find_maximum_inner_products(self, query, conditioner=None,
                                    k: int = 1) -> List[BestMatch]:
        if conditioner is None:
            return super().find_maximum_inner_products(query, k)
        idx, scores = self.query_batch_conditional(
            np.asarray(query)[None, :], [conditioner], k)
        keep = np.isfinite(scores[0])
        return [BestMatch(i, s) for i, s in zip(idx[0][keep], scores[0][keep])]

    findMaximumInnerProducts = find_maximum_inner_products
