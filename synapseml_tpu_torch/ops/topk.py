"""Top-k along the last axis with ``jax.lax.top_k``'s order: values
descending, and among equal values the lower index first.

``torch.topk`` returns the right values but breaks ties in an order of its
own, and recommendation and nearest-neighbour scores tie often (every item a
SAR user's history never reaches scores 0; a conditioned query with fewer
admissible keys than k fills its answer with −inf). ``top_k`` finds the k-th
largest value with ``torch.topk``, keeps every entry above it and the
lowest-index entries equal to it, and orders the k kept entries by
(−value, index) with a stable sort of k columns. Plain PyTorch operations,
with no host read: it runs inside a captured CUDA graph.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of each row of
    ``scores`` (last axis), in ``jax.lax.top_k``'s order. Indices are
    int64."""
    n = scores.shape[-1]
    kth = torch.topk(scores, k, dim=-1).values[..., -1:]
    above = scores > kth
    at = scores == kth
    room = k - above.sum(dim=-1, keepdim=True, dtype=torch.int32)
    keep = above | (at & (torch.cumsum(at, dim=-1, dtype=torch.int32) <= room))
    # exactly k kept per row: the k largest of (n - index) over them are
    # the kept indices, ascending
    rank = n - torch.arange(n, dtype=torch.int32, device=scores.device)
    idx = torch.topk(torch.where(keep, rank, 0), k, dim=-1).indices
    order = torch.sort(torch.gather(scores, -1, idx), dim=-1,
                       descending=True, stable=True).indices
    idx = torch.gather(idx, -1, order)
    return torch.gather(scores, -1, idx), idx
