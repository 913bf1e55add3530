"""Depthwise (level-batched) tree grower — one ``level_histograms`` pass per
level.

Counterpart of the JAX package's ``gbdt/grower_depthwise.py``: the opt-in
``growth_policy="depthwise"``. Where the leaf-wise grower takes one split per
step, this one splits every candidate leaf of a level at once:

  * rows are kept partitioned by leaf, each leaf's rows starting at a chunk
    boundary (``CHUNK`` rows; padding rows carry zero grad/hess/mask), so ONE
    ``level_histograms`` pass histograms every leaf of the tree;
  * one stable sort + one aligned gather re-partitions all rows per level;
  * split finding runs over all leaves at once (``_best_for_leaf``).

Within a level the splits are applied in gain order (a stable descending
order of the leaves' gains), and the ``num_leaves`` budget cuts the last
level by gain, so the trees are the JAX package's, split for split. Every
level recomputes every leaf's histogram from its rows (no parent-minus-child
subtraction): the float32 sums, and so the trees, are the reference's.

Where the state lives. The routing, the sort, the gather, the histograms and
split scoring stay on the device. The bookkeeping sits on the host
(``grower._TreeBook``, shared with the leaf-wise grower): each level pass
ends with ONE read of the ``(L, 8)`` best-split rows (with categorical
features, each row's bitset words too), the host applies the level's
splits and uploads the level's plan (``do``, ``fsel``, ``bsel``, ``dl``,
``cat``, ``right_of``, each ``(L,)``, and the ``(L, ceil(B / 32))``
bitsets) in one transfer. The last pass is not read when the
budget or the depth limit already ends the tree, so a tree costs
``passes - 1`` host syncs then and ``passes`` otherwise, where ``passes`` is
1 (the root) plus the number of levels that applied a split.

Per-node feature masks follow each slot's node id (``_TreeBook.mask_id``,
uploaded with the level's plan), as the JAX grower's ``mask_id``; monotone
constraints mask candidates in ``_best_for_leaf`` as in the leaf-wise
grower.

A categorical split routes a row left when its bin is in the split's bitset
(``grower._member``).

On a mesh (``group``, the data axis's process group) each rank holds its
block of rows, and every level's histograms, the root's too, are reduced
over the group (``grower._maybe_psum``, on ``cfg.hist_allreduce_dtype``'s
wire) before any decision reads them. They are masked first by ``exists``,
the leaves of the tree, which every rank has alike, and never by a leaf's
local row count: a leaf with no rows on one rank may hold rows on another.
Nothing else the host decides reads a local count (the plan comes from the
reduced histograms; the re-partition gives every existing leaf at least one
chunk on every rank).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.hist_kernel import (CHUNK, features_padded, level_histograms,
                               pad_bins)
from .grower import (GrowerConfig, _best_for_leaf, _maybe_psum, _member,
                     _padded_categorical, _padded_features, _to_host,
                     _TreeBook, node_masks, transpose_bins)


class _LevelPlan(NamedTuple):
    """One level's applied splits, indexed by a row's current leaf: device
    tensors of shape (L,)."""

    do: torch.Tensor          # bool — the leaf splits this level
    fsel: torch.Tensor        # i64 split feature
    bsel: torch.Tensor        # i64 bin threshold (left if bin <= it)
    dl: torch.Tensor          # bool default-left (NaN bin's side)
    right_of: torch.Tensor    # i64 right child's leaf (itself if unsplit)
    mask_id: torch.Tensor     # i64 each slot's node id after the level
    cat: torch.Tensor         # bool categorical split
    bits: torch.Tensor        # (L, BW) i64 its bitset words


def _level_candidates(book: _TreeBook, level: int, cfg: GrowerConfig):
    """(do, order): which leaves split at ``level``, and all leaves in gain
    order — a stable descending sort, so equal gains keep leaf order, as
    ``jnp.argsort(-gains)`` does. Only leaves at depth ``level`` are
    candidates; the ``num_leaves`` budget keeps the best."""
    L = book.L
    exists = np.arange(L) <= book.num_splits
    gains = np.where(exists & (book.depth == level), book.bgain,
                     np.float32(-np.inf)).astype(np.float32)
    order = np.argsort(-gains, kind="stable")
    rank = np.empty(L, np.int64)
    rank[order] = np.arange(L)
    budget = (L - 1) - book.num_splits
    return (gains > np.float32(cfg.min_gain_to_split)) & (rank < budget), order


def _apply_level_splits(book: _TreeBook, do, order, cfg: GrowerConfig, dev
                        ) -> _LevelPlan:
    """Apply the level's splits to ``book`` in gain order; returns the plan
    the rows route by, uploaded in one transfer."""
    L = book.L
    plan = np.zeros((7 + book.bbits.shape[1], L), np.int64)
    plan[4] = np.arange(L)                         # right_of: identity
    for l in order:
        if not do[l]:
            continue
        plan[:4, l] = 1, book.bfeat[l], book.bbin[l], book.bdl[l]
        i_node = book.num_splits
        plan[4, l] = book.split(int(l), cfg)
        plan[6, l] = book.split_type[i_node]
        plan[7:, l] = book.cat_bitset[i_node]
    plan[5] = book.mask_id
    p = torch.as_tensor(plan, device=dev)
    return _LevelPlan(do=p[0] != 0, fsel=p[1], bsel=p[2], dl=p[3] != 0,
                      right_of=p[4], mask_id=p[5], cat=p[6] != 0,
                      bits=p[7:].T)


def _route_level(bT, rleaf, plan: _LevelPlan, nanp, has_categorical=False):
    """Each row's leaf after the level's splits: ``bT`` (FP, R) bins,
    ``rleaf`` (R,) current leaves → (R,) new leaves."""
    fr = plan.fsel[rleaf]
    binrow = bT.gather(0, fr[None, :])[0]
    gr = binrow > plan.bsel[rleaf]
    gr = torch.where(binrow == nanp[fr], ~plan.dl[rleaf], gr)
    if has_categorical:
        gr = torch.where(plan.cat[rleaf],
                         ~_member(plan.bits[rleaf], binrow.to(torch.int64)),
                         gr)
    return torch.where(plan.do[rleaf] & gr, plan.right_of[rleaf], rleaf)


def _repartition(new_rleaf, is_pad, exists, chunk: int, CAP: int):
    """Destination → source map of the chunk-aligned re-partition.

    Rows are stably sorted by new leaf, padding last; each existing leaf
    gets ``max(ceil(count / chunk), 1)`` chunks, the leaves' runs laid out
    in leaf order from row 0. Returns (src (CAP,) source row of each
    destination, valid (CAP,) whether it holds a row, slot (CAP,) its leaf,
    start_chunks (L,) each leaf's first chunk, CAP // chunk for a leaf that
    does not exist)."""
    L = exists.shape[0]
    R = new_rleaf.shape[0]
    dev = new_rleaf.device
    key = torch.where(is_pad, L, new_rleaf)
    sorted_key, src_sorted = torch.sort(key, stable=True)
    leaves = torch.arange(L, device=dev)
    first = torch.searchsorted(sorted_key, leaves)
    counts = torch.searchsorted(sorted_key, leaves, right=True) - first
    cap_chunks = torch.where(exists, torch.clamp_min(-(-counts // chunk), 1),
                             0)
    base_chunk = torch.cumsum(cap_chunks, 0) - cap_chunks
    leaf_start = torch.where(exists, base_chunk * chunk, CAP)
    q = torch.arange(CAP, device=dev)
    slot = torch.searchsorted(base_chunk, q // chunk, right=True) - 1
    slot = slot.clamp(0, L - 1)
    r = q - leaf_start[slot]
    valid = (r >= 0) & (r < counts[slot])
    src = src_sorted[(first[slot] + r).clamp(0, R - 1)]
    src = torch.where(valid, src, 0)
    return src, valid, slot, leaf_start // chunk


def grow_tree_depthwise(binned, grad, hess, in_bag, feature_active,
                        cfg: GrowerConfig, nan_bins=None, bT0=None,
                        stats: Optional[dict] = None, monotone=None,
                        node_key=None, is_categorical=None, cat_nbins=None,
                        group=None):
    """Grow one tree level by level; arguments and result as
    ``grower.grow_tree`` (``bT0`` is read, never modified); ``group``: the
    mesh's data axis this rank's block of rows is reduced over."""
    n, f = binned.shape
    dev = binned.device
    L = cfg.num_leaves
    B = pad_bins(cfg.num_bins)
    FP = features_padded(f)
    chunk = CHUNK
    CAP = -(-n // chunk) * chunk + L * chunk    # every leaf rounds up a chunk
    max_levels = cfg.max_depth if cfg.max_depth > 0 else L - 1

    # the root pass runs on the (FP, n) rows as given; the first re-partition
    # moves them into the CAP-row layout. pos == n marks a padding row.
    bT = transpose_bins(binned) if bT0 is None else bT0
    in_bag = in_bag.to(torch.float32)
    gs = grad.to(torch.float32) * in_bag
    hs = hess.to(torch.float32) * in_bag
    ms = in_bag
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    rleaf = torch.zeros(n, dtype=torch.int64, device=dev)
    featp, nanp, _, monop = _padded_features(feature_active, nan_bins, FP,
                                             dev, monotone)
    catp, catb, catp_host = _padded_categorical(cfg, is_categorical,
                                                cat_nbins, FP, B, dev)
    masks = node_masks(cfg, featp, node_key, L)
    root_starts = torch.full((L,), CAP // chunk, dtype=torch.int32,
                             device=dev)
    root_starts[0] = 0

    def level_pass(bT, gs, hs, ms, starts, rleaf, exists):
        hist = level_histograms(bT, gs, hs, ms, starts, rleaf, B, L)
        if group is None:
            return hist
        hist = torch.where(exists[:, None, None, None], hist, 0.0)
        return _maybe_psum(hist, group, cfg.hist_allreduce_dtype)

    hist = level_pass(bT, gs, hs, ms, root_starts, rleaf,
                      torch.arange(L, device=dev) == 0)

    book = _TreeBook(L, B, catp_host)
    level = 0

    def growing() -> bool:
        return book.num_splits < L - 1 and level < max_levels

    if growing():
        root_mask = featp if masks is None else masks[2 * (L - 1)]
        book.set_best([0], _to_host(
            _best_for_leaf(hist[:1], root_mask, nanp, cfg, monop, catp,
                           catb), stats))
    while growing():
        do, order = _level_candidates(book, level, cfg)
        if not do.any():
            break
        plan = _apply_level_splits(book, do, order, cfg, dev)
        new_rleaf = _route_level(bT, rleaf, plan, nanp, catp is not None)
        exists = torch.arange(L, device=dev) <= book.num_splits
        src, valid, rleaf, start_chunks = _repartition(
            new_rleaf, pos >= n, exists, chunk, CAP)
        bT = bT.index_select(1, src).masked_fill_(~valid[None, :], 0)
        gs = torch.where(valid, gs[src], 0.0)
        hs = torch.where(valid, hs[src], 0.0)
        ms = torch.where(valid, ms[src], 0.0)
        pos = torch.where(valid, pos[src], n)
        hist = level_pass(bT, gs, hs, ms, start_chunks, rleaf, exists)
        level += 1
        if growing():
            slot_masks = featp if masks is None else masks[plan.mask_id]
            rows = _to_host(_best_for_leaf(hist, slot_masks, nanp, cfg,
                                           monop, catp, catb), stats)
            book.set_best(np.arange(L), rows)
            book.bgain[book.num_splits + 1:] = -np.inf

    tree = book.tree(hist, cfg)
    node = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    node[pos] = rleaf                        # padding rows all land on n
    return tree, node[:n]
