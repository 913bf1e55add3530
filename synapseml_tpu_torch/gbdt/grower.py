"""Leaf-wise histogram tree grower — partitioned rows + CUDA histogram kernels.

Counterpart of the JAX package's ``gbdt/grower.py`` for its default path:
leaf-wise growth, the "partition" row layout, numeric features with a learned
NaN direction. The JAX grower is one ``lax.fori_loop`` over static shapes with
``lax.switch`` size buckets; eager PyTorch has dynamic shapes, so here the
loop is plain Python and every slice has its exact size.

  * **Row partitioning** (LightGBM's DataPartition): rows live in a position
    array kept sorted by leaf, each leaf owning a contiguous range. A split
    stably partitions only its leaf's range (``torch.argsort(stable=True)``
    of the go-right key), moving grad/hess/mask and the ``(FP, n)`` bins with
    it.
  * **Histogram subtraction**: per split only the SMALLER child's histogram
    is built (``range_histogram`` over the child's row range of the full
    arrays); the sibling is parent − child from the per-leaf cache.
  * Leaf numbering matches LightGBM's Tree::Split: splitting leaf ``l`` at
    step ``i`` creates internal node ``i``; the left child keeps leaf id
    ``l``, the right child becomes leaf ``i + 1``; child pointers use
    ``~leaf_index``.
  * **Learned missing direction**: every candidate threshold is scored with
    the NaN bin's totals routed left AND right; the winner is the split's
    ``default_left``.

Where the state lives: histograms, the row partition and split scoring stay
on the device. The split bookkeeping (leaf ranges, the tree arrays) sits on
the host (``_TreeBook``, shared with the depthwise grower): each split's
decision is read back in ONE transfer of 17 numbers, so a tree costs
``1 + num_splits`` host syncs (counted in ``stats``). The range kernel itself
takes the child's start/length as a device tensor, so the syncs can later go
without touching the kernel.

``GrowerConfig(growth_policy="depthwise")`` sends ``grow_tree`` to the
level-batched grower of ``grower_depthwise.py`` instead.

Sampling and constraints: ``feature_active`` is the tree's feature mask
(``feature_fraction``); with ``feature_fraction_bynode`` below 1 every
node's split search sees its own subset, drawn from the tree's
``node_key`` with the JAX package's node ids (the root ``2 (L - 1)``, the
children of split ``i`` ``2i`` and ``2i + 1``), all ``2L - 1`` masks in
one batched draw per tree (``node_masks``), so sampling adds no host
sync. ``monotone`` (-1 / 0 / +1 per feature) drops every candidate whose
two child outputs ``-G / (H + l2)`` break the constraint, as the JAX
grower does; like it, this bounds no split's descendants (LightGBM's
basic method also clamps them), so the raw score need not be monotone.

  * **Categorical splits** (``has_categorical``; LightGBM's many-vs-many
    algorithm): a categorical feature's bins are ordered by
    ``G / (H + cat_smooth)`` (a stable sort; bins with fewer than
    ``min_data_per_group`` rows last), and the candidates are the prefixes
    of that order (at most ``max_cat_threshold``) or, for a feature of at
    most ``max_cat_to_onehot`` categories, single categories
    (one-vs-rest); their gains carry ``l2 + cat_l2``. The winning set
    travels as a bitset of ``ceil(B / 32)`` uint32 words: built on the
    device by the split search itself (``_best_for_leaf``, one order shared
    with the scan) and read back with the split's record, so a categorical
    tree costs no more host syncs than a numeric one. A row goes left when
    its bin is in the set.

Distributed (``mesh=``): every rank grows the same tree from its own
block of rows. After each histogram kernel (the root's ``child_histogram``,
each smaller child's ``range_histogram``) the histogram is reduced over the
mesh's ``data`` axis before any decision reads it (``_maybe_psum``, on the
wire ``cfg.hist_allreduce_dtype`` picks), so every split decision, the
smaller child included (it comes from the global count), and the leaf
values are the same on every rank; only the partition and each leaf's row
range are a rank's own. A rank whose child has no local rows still launches
the kernel and joins the collective. With ``cfg.hist_reduce="scatter"``
(the feature-parallel learner) the histogram is reduce-scattered over the
features instead: each rank keeps and scores its ``FP / W`` owned
features, the ranks exchange their best candidates (``_exchange_best``:
the higher gain wins, the lower rank on a tie) and take the leaf totals of
rank 0, whose owned slice starts with feature 0, as the JAX package's
replicated output does.

Hot-loop designs (``cfg.row_layout``; every one grows the partition
layout's trees, the JAX grower's three):

  * ``"partition"`` (above). ``cfg.partition_impl`` picks the primitive of
    the stable partition (``stable_partition_src``: ``"sort"``, the
    ``"sort32"`` composite-key sort, the ``"scan"`` rank search or the
    ``"scatter"`` inversion, each exactly ``argsort(stable=True)``'s
    source indices). ``cfg.use_segmented=False`` builds the smaller child
    with ``child_histogram`` on a window of the sorted rows aligned down to
    ``CHUNK``, the child's range mask multiplied into g, h and m, instead
    of ``range_histogram``.
  * ``"gather"``: rows stay in their original order; only the ``pos``
    permutation is kept sorted by leaf, and the smaller child's rows are
    gathered through it for ``child_histogram``. The gather needs the
    child's row count on the host: one more host read per split.
  * ``"masked"``: rows never move. A per-row ``node`` vector routes them,
    and every split runs ``child_histogram`` over all rows with the smaller
    child's membership multiplied into g, h and m.

Within a leaf every layout keeps the rows in original row order, so the
histogram sums, and the trees, are the same.
"""

from __future__ import annotations

import math
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core import prng
from ..ops.hist_kernel import (CHUNK, child_histogram, features_padded,
                               pad_bins, range_histogram)
from ..parallel import collectives as coll

BITS = 32  # bitset word width for categorical splits
NO_NAN_BIN = 0x7FFF
REC = 8    # leading columns of a best-split record (``_best_for_leaf``)


class GrowerConfig(NamedTuple):
    """Grower configuration (the ported subset of the JAX GrowerConfig)."""

    num_leaves: int = 31
    num_bins: int = 255
    max_depth: int = -1          # <=0: unlimited (bounded by num_leaves anyway)
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    learning_rate: float = 0.1
    max_delta_step: float = 0.0
    growth_policy: str = "leafwise"  # or "depthwise" (grower_depthwise.py)
    feature_fraction_bynode: float = 1.0
    cat_smooth: float = 10.0
    cat_l2: float = 10.0         # extra L2 applied to categorical split gains
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4   # <= this many categories: one-vs-rest splits
    min_data_per_group: int = 100  # thin categorical groups excluded
    has_categorical: bool = False  # the split search scores categorical bins
    # histogram reduction over a mesh's data axis: its wire ("f32", "bf16":
    # grad/hess at half width, "int8": the blockwise-quantized all-reduce;
    # counts always exact float32) and its shape ("allreduce": every rank
    # gets the whole histogram; "scatter": each of ``feature_shards`` ranks
    # keeps its FP / feature_shards owned features, the feature learner)
    hist_allreduce_dtype: str = "f32"
    hist_reduce: str = "allreduce"
    feature_shards: int = 1
    # the leaf-wise hot loop (module docstring): the stable partition's
    # primitive, the row layout, and range_histogram (None / True) or a
    # masked child_histogram window (False) for the partition layout
    partition_impl: str = "sort"
    row_layout: str = "partition"
    use_segmented: Optional[bool] = None


# per-rank traffic of the histogram reductions since the last reset: calls
# of a collective, the bytes this rank contributed to them and the wall
# seconds of the reductions (host staging and waiting included)
WIRE = {"collectives": 0, "bytes": 0, "seconds": 0.0}


def reset_wire_counts() -> None:
    WIRE.update(collectives=0, bytes=0, seconds=0.0)


def _wire(calls: int, nbytes: int) -> None:
    WIRE["collectives"] += calls
    WIRE["bytes"] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _int8_wire_bytes(numel: int, block: int) -> int:
    """Bytes of the quantized wire's two collectives: one float32 max per
    block and one 2-byte grid value per element."""
    nblk = -(-numel // block)
    return 4 * nblk + 2 * nblk * block


def resolve_wire_dtype(cfg, mesh, n_rows, nfeat):
    """``(wire, perfmodel.Decision)`` for ``hist_allreduce_dtype="auto"``
    (``cfg`` a ``BoosterConfig``): every rung's analytic per-tree seconds
    from the mesh's measured link go into the provenance, and, with no
    recorded rows to trust (``core.perfmodel``), the exact f32 wire is
    chosen, as the JAX package chooses without a measured match."""
    from ..core import perfmodel
    from ..parallel.mesh import DATA_AXIS

    if mesh is None:
        return "f32", perfmodel.Decision(
            "gbdt_wire_dtype", "f32", "f32", None, 0.0, True, "f32",
            "fallback", [], {"workers": 1.0})
    workers = int(dict(mesh.shape).get(DATA_AXIS, 1))
    link = perfmodel.link_bandwidth(mesh) if workers > 1 else None
    return perfmodel.suggest_wire_dtype(
        n_rows=float(n_rows), nfeat=float(nfeat), workers=float(workers),
        max_bin=float(cfg.max_bin), num_leaves=float(cfg.num_leaves),
        link_bps=link)


# Float32 sums over a histogram's bins in the order of XLA's CPU backend,
# measured bitwise against jnp on float32 arrays of the grower's shapes (B a
# power of two of at least 32, as every pad_bins size is): jnp.sum(x,
# axis=-2) folds each block of 32 consecutive bins in bin order, then sums
# the block sums the same way (in one fold once 32 or fewer are left);
# jnp.cumsum(x, axis=-2) (a reduce_window) scans each block of 16 bins in
# order, scans the block totals the same way, and adds each block's
# exclusive carry. On the CPU the port sums in those orders, so split gains,
# leaf totals and a lossy wire's pinned totals are the JAX package's to the
# bit. On the card each stays one sum / cumsum call: the card is held by
# tolerance, and the folds would cost some 30 launches per call, about
# 31 x B a tree.
XLA_SUM_BLOCK = 32
XLA_SCAN_BLOCK = 16


def _fold(x: torch.Tensor) -> torch.Tensor:
    """Sequential float32 sum over dim -2."""
    out = x[..., 0, :]
    for i in range(1, x.shape[-2]):
        out = out + x[..., i, :]
    return out


def _xla_sum(x: torch.Tensor) -> torch.Tensor:
    B = x.shape[-2]
    if B <= XLA_SUM_BLOCK:
        return _fold(x)
    return _xla_sum(_fold(x.unflatten(-2, (B // XLA_SUM_BLOCK,
                                           XLA_SUM_BLOCK))))


def _pow2(n: int) -> bool:
    return n >= XLA_SUM_BLOCK and n & (n - 1) == 0


def _bin_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., B, C) summed over its bins (dim -2), in XLA's order on
    the CPU (see above)."""
    if x.is_cuda or not _pow2(x.shape[-2]):
        return x.sum(dim=-2)
    return _xla_sum(x)


def _scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over dim -2 in XLA's reduce_window order."""
    B, k = x.shape[-2], XLA_SCAN_BLOCK
    if B <= k:
        out = [x[..., 0, :]]
        for i in range(1, B):
            out.append(out[-1] + x[..., i, :])
        return torch.stack(out, dim=-2)
    w = _scan(x.unflatten(-2, (B // k, k)))             # (..., B / k, k, C)
    tot = _scan(w[..., -1, :])                          # (..., B / k, C)
    carry = torch.cat([torch.zeros_like(tot[..., :1, :]), tot[..., :-1, :]],
                      dim=-2)
    return (w + carry.unsqueeze(-2)).flatten(-3, -2)


def _bin_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of ``x`` (..., B, C) over its bins, in XLA's
    order on the CPU (see above)."""
    if x.is_cuda or not _pow2(x.shape[-2]):
        return torch.cumsum(x, dim=-2)
    return _scan(x)


def _pin_totals(gh, tot):
    """Pin each feature's row of a lossy-wire histogram ``gh`` (..., FP, B,
    2) to its exactly reduced totals ``tot`` (..., FP, 2), spreading the
    residual over the bins in proportion to |bin|: empty bins stay zero and
    the leaf totals the grower reads carry no wire rounding."""
    absg = gh.abs()
    mass = _bin_sum(absg).unsqueeze(-2)
    err = (tot - _bin_sum(gh)).unsqueeze(-2)
    return gh + err * absg / torch.where(mass > 0, mass, 1.0)


def _maybe_psum(x, group, wire_dtype: str = "f32"):
    """The histogram all-reduce over ``group`` (None: no mesh, ``x`` as
    is) of (..., FP, B, 3) partials. ``"bf16"`` ships grad/hess at half
    width and ``"int8"`` on the quantized wire (channel-major, so a block
    never mixes grad with hess magnitudes); both pin each feature's totals
    over an exact float32 side wire, and the count channel always rides an
    exact float32 wire (it gates ``min_data_in_leaf``). The side wire and
    the counts travel in one float32 collective (each element is summed on
    its own, so one call gives the sums of two)."""
    if group is None:
        return x
    t0 = time.perf_counter()
    if wire_dtype in ("bf16", "int8"):
        lead = x.shape[:-1]
        tot = _bin_sum(x[..., :2])                       # (..., FP, 2)
        exact = torch.cat([tot.reshape(-1), x[..., 2].reshape(-1)])
        if wire_dtype == "bf16":
            half = x[..., :2].to(torch.bfloat16)
            gh = coll.allreduce_sum(half, group).to(x.dtype)
            _wire(2, _nbytes(half) + _nbytes(exact))
        else:
            ghc = torch.movedim(x[..., :2], -1, 0).contiguous()
            gh = torch.movedim(coll.allreduce_sum_quantized(ghc, group),
                               0, -1).to(x.dtype)
            _wire(3, _int8_wire_bytes(ghc.numel(), 256) + _nbytes(exact))
        summed = coll.allreduce_sum(exact, group)
        tot_r = summed[:tot.numel()].reshape(tot.shape)
        cnt = summed[tot.numel():].reshape(*lead, 1)
        out = torch.cat([_pin_totals(gh, tot_r), cnt], dim=-1)
    else:
        out = coll.allreduce_sum(x, group)
        _wire(1, _nbytes(x))
    WIRE["seconds"] += time.perf_counter() - t0
    return out


def _hist_reduce_scatter(x, group, wire_dtype: str = "f32"):
    """Owned-feature reduction: (FP, B, 3) partials → this rank's fully
    summed (FP / W, B, 3) slice (a reduce-scatter over the features, the
    wire LightGBM's data-parallel learner actually runs, about half the
    bytes of an all-reduce). The lossy wires pin the owned totals over an
    exact float32 side wire, and the counts stay exact, as in
    ``_maybe_psum``."""
    if group is None:
        return x
    t0 = time.perf_counter()
    FP, B, _ = x.shape
    if wire_dtype in ("bf16", "int8"):
        tot = _bin_sum(x[..., :2])                       # (FP, 2)
        exact = torch.cat([tot, x[..., 2]], dim=1)       # (FP, 2 + B)
        if wire_dtype == "bf16":
            half = x[..., :2].to(torch.bfloat16).contiguous()
            gh = coll.reduce_scatter_sum(half, group).to(x.dtype)
            _wire(2, _nbytes(half) + _nbytes(exact))
        else:
            ghT = x[..., :2].transpose(1, 2).contiguous()   # (FP, 2, B)
            block = math.gcd(256, B)
            gh = coll.reduce_scatter_sum_quantized(
                ghT, group, block=block).transpose(1, 2)
            _wire(3, _int8_wire_bytes(ghT.numel(), block) + _nbytes(exact))
        summed = coll.reduce_scatter_sum(exact.contiguous(), group)
        out = torch.cat([_pin_totals(gh.to(x.dtype), summed[:, :2]),
                         summed[:, 2:, None]], dim=-1)
    else:
        out = coll.reduce_scatter_sum(x.contiguous(), group)
        _wire(1, _nbytes(x))
    WIRE["seconds"] += time.perf_counter() - t0
    return out


class TreeArrays(NamedTuple):
    """One grown tree in structure-of-arrays form (serializes to the LightGBM
    model-string fields of the same names — gbdt/model_io.py). Host numpy
    arrays, except that ``grow_tree`` returns the three leaf fields as
    device tensors (``tree_to_host`` brings them over)."""

    split_feature: np.ndarray    # (L-1,) i32
    split_bin: np.ndarray        # (L-1,) i32 — bin-space threshold (left if bin <= t)
    split_gain: np.ndarray       # (L-1,) f32
    split_type: np.ndarray       # (L-1,) i32 — 0 numeric, 1 categorical
    default_left: np.ndarray     # (L-1,) bool — learned NaN direction
    cat_bitset: np.ndarray       # (L-1, ceil(B/32)) u32 — membership → left
    left_child: np.ndarray       # (L-1,) i32 — >=0 internal node, ~leaf otherwise
    right_child: np.ndarray      # (L-1,) i32
    internal_value: np.ndarray   # (L-1,) f32 (shrunk output the node would emit)
    internal_count: np.ndarray   # (L-1,) i32
    leaf_value: np.ndarray       # (L,) f32 (shrinkage applied, LightGBM-style)
    leaf_weight: np.ndarray      # (L,) f32 (sum of hessians)
    leaf_count: np.ndarray       # (L,) i32
    num_splits: np.ndarray       # () i32


def tree_to_host(tree: TreeArrays) -> TreeArrays:
    return trees_to_host([tree])[0]


def trees_to_host(trees: List[TreeArrays]) -> List[TreeArrays]:
    """Bring the device-side leaf fields of many trees over in one transfer."""
    dev = [t for t in trees if isinstance(t.leaf_value, torch.Tensor)]
    if not dev:
        return list(trees)
    packed = torch.stack([torch.stack([t.leaf_value, t.leaf_weight,
                                       t.leaf_count.to(torch.float32)])
                          for t in dev]).cpu().numpy()
    out, j = [], 0
    for t in trees:
        if isinstance(t.leaf_value, torch.Tensor):
            p = packed[j]
            j += 1
            t = t._replace(leaf_value=p[0].copy(), leaf_weight=p[1].copy(),
                           leaf_count=p[2].astype(np.int32))
        out.append(t)
    return out


# ---------------------------------------------------------------------------
# Leaf arithmetic (float32 throughout, as in the JAX grower)
# ---------------------------------------------------------------------------

def _threshold_l1(g, l1):
    return torch.sign(g) * torch.clamp_min(torch.abs(g) - l1, 0.0)


def _leaf_objective(g, h, l1, l2):
    """LightGBM GetLeafSplitGain: ThresholdL1(G)^2 / (H + l2)."""
    gt = _threshold_l1(g, l1)
    return gt * gt / (h + l2)


def _leaf_output(g, h, cfg: GrowerConfig):
    out = -_threshold_l1(g, cfg.lambda_l1) / (h + cfg.lambda_l2)
    if cfg.max_delta_step > 0:
        out = torch.clamp(out, -cfg.max_delta_step, cfg.max_delta_step)
    return out


def _leaf_output_host(g, h, cfg: GrowerConfig) -> np.float32:
    """``_leaf_output(g, h) * learning_rate`` for one leaf on the host, with
    the same float32 operations."""
    f32 = np.float32
    g, h = f32(g), f32(h)
    with np.errstate(divide="ignore", invalid="ignore"):
        gt = np.sign(g) * np.maximum(np.abs(g) - f32(cfg.lambda_l1), f32(0.0))
        out = -gt / (h + f32(cfg.lambda_l2))
    if cfg.max_delta_step > 0:
        out = np.clip(out, -f32(cfg.max_delta_step), f32(cfg.max_delta_step))
    return f32(out) * f32(cfg.learning_rate)


# ---------------------------------------------------------------------------
# Stable partition primitives
# ---------------------------------------------------------------------------

PARTITION_IMPLS = ("sort", "sort32", "scan", "scatter")


def stable_partition_src(key: torch.Tensor, impl: str = "sort"
                         ) -> torch.Tensor:
    """(n,) int64 source indices of the stable partition of ``key`` (n,)
    (integer values in {-1, 0, 1, 2}): exactly ``torch.argsort(key,
    stable=True)``, by one of the JAX grower's four primitives.

    ``"sort32"`` sorts one int32 composite key, ``(key + 1)`` above the
    row's position, whose ascending order is the stable partition (above
    2^29 rows the composite no longer fits and it sorts by ``argsort``);
    ``"scatter"`` computes each element's destination from per-value
    running counts and inverts that permutation with one scatter;
    ``"scan"`` finds the source of each output slot by a binary search of
    its rank in its value's running count. None reads the device."""
    if impl not in PARTITION_IMPLS:
        raise ValueError("partition_impl must be 'sort', 'sort32', 'scan' "
                         f"or 'scatter', got {impl!r}")
    n = key.shape[0]
    dev = key.device
    if impl == "sort" or n == 0:
        return torch.argsort(key, stable=True)
    if impl == "sort32":
        if n > (1 << 29):
            return torch.argsort(key, stable=True)
        shift = max(n - 1, 1).bit_length()
        comp = (((key.to(torch.int32) + 1) << shift)
                | torch.arange(n, dtype=torch.int32, device=dev))
        return (torch.sort(comp).values & ((1 << shift) - 1)).to(torch.int64)
    if impl == "scatter":
        dst = torch.zeros(n, dtype=torch.int64, device=dev)
        off = torch.zeros((), dtype=torch.int64, device=dev)
        for v in (-1, 0, 1, 2):
            isv = key == v
            rank = torch.cumsum(isv, 0) - 1
            dst = torch.where(isv, off + rank, dst)
            off = off + rank[-1] + 1
        return torch.empty(n, dtype=torch.int64, device=dev).scatter_(
            0, dst, torch.arange(n, dtype=torch.int64, device=dev))
    j = torch.arange(n, dtype=torch.int64, device=dev)
    cums = [torch.cumsum(key == v, 0) for v in (-1, 0, 1, 2)]
    offs = torch.cumsum(torch.stack(
        [torch.zeros((), dtype=torch.int64, device=dev)]
        + [c[-1] for c in cums[:3]]), 0)
    pick = torch.full((n,), 3, dtype=torch.int64, device=dev)
    for ci in (2, 1, 0):
        pick = torch.where(j < offs[ci + 1], ci, pick)
    src = torch.zeros(n, dtype=torch.int64, device=dev)
    for ci, c in enumerate(cums):
        s = torch.searchsorted(c, j - offs[ci] + 1, side="left")
        src = torch.where(pick == ci, s, src)
    return src


# ---------------------------------------------------------------------------
# Split finding over leaf histograms
# ---------------------------------------------------------------------------

def _cat_order_usable(hist, cfg: GrowerConfig):
    """Categorical ordering state of (..., B, 3) histograms: (each feature's
    bins ordered by G / (H + cat_smooth), thin groups last; the count of
    usable bins). ONE definition for the split search and the winning
    bitset, which must agree bit for bit; the sort is stable, as
    ``jnp.argsort``, so ties (common among empty bins) keep bin order."""
    cnt = hist[..., 2]
    usable = (cnt >= cfg.min_data_per_group) & (cnt > 0)
    key = torch.where(usable, hist[..., 0] / (hist[..., 1] + cfg.cat_smooth),
                      torch.inf)
    return torch.argsort(key, dim=-1, stable=True), usable.sum(dim=-1)


def _best_for_leaf(hist, feature_mask, nan_bins, cfg: GrowerConfig,
                   monotone=None, catp=None, catb=None):
    """hist (K, FP, B, 3) → (K, 8) float64 rows of
    [gain, feature, bin, default_left, count_left, G, H, C] — each leaf's
    best split (numeric with a learned NaN direction, or categorical) and
    its totals; with ``cfg.has_categorical`` each row carries the winner's
    ``ceil(B / 32)`` bitset words after those 8 (``_winning_bitset``).
    ``feature_mask`` is (FP,) for every leaf or (K, FP) per leaf;
    ``monotone`` (FP,) int -1/0/+1 or None (no constraint); ``catp`` (FP,)
    bool marks the categorical features and ``catb`` (FP,) their category
    counts (which pick one-vs-rest). A categorical winner's ``bin`` is its
    position in the feature's bin order."""
    K, FP, B, _ = hist.shape
    l1, l2 = cfg.lambda_l1, cfg.lambda_l2
    totals = _bin_sum(hist[:, 0])                      # (K, 3) — feature 0 spans the leaf
    G = totals[:, 0, None, None]
    H = totals[:, 1, None, None]
    C = totals[:, 2, None, None]
    cum = _bin_cumsum(hist)                            # (K, FP, B, 3)
    l2s, order = l2, None
    if cfg.has_categorical:
        # a categorical feature scans its bins in their order: prefixes
        # (many-vs-many) or, with at most max_cat_to_onehot categories,
        # single categories (one-vs-rest: the unsummed sorted histogram);
        # the mode comes from the feature's category count, not from the
        # leaf's occupancy. Its gains carry l2 + cat_l2, in the children
        # and the parent term alike; one scan serves both kinds
        order, n_usable = _cat_order_usable(hist, cfg)
        hist_sorted = torch.gather(hist, 2,
                                   order[..., None].expand(K, FP, B, 3))
        onehot = (catb <= cfg.max_cat_to_onehot)[None, :, None]
        is_cat = catp[None, :, None]
        cum = torch.where(is_cat[..., None], torch.where(
            onehot[..., None], hist_sorted,
            _bin_cumsum(hist_sorted)), cum)
        l2c = float(np.float32(l2) + np.float32(cfg.cat_l2))
        l2s = torch.where(is_cat, l2c, l2)            # (1, FP, 1) float32
    parent = _leaf_objective(G, H, l1, l2s)

    def scan_gains(cum, extra=None):
        GL, HL, CL = cum[..., 0], cum[..., 1], cum[..., 2]
        if extra is not None:
            GL, HL, CL = GL + extra[..., 0], HL + extra[..., 1], CL + extra[..., 2]
        GR, HR, CR = G - GL, H - HL, C - CL
        gain = (_leaf_objective(GL, HL, l1, l2s)
                + _leaf_objective(GR, HR, l1, l2s) - parent)
        valid = ((CL >= cfg.min_data_in_leaf) & (CR >= cfg.min_data_in_leaf)
                 & (HL >= cfg.min_sum_hessian_in_leaf)
                 & (HR >= cfg.min_sum_hessian_in_leaf))
        if monotone is not None:
            # the child outputs without l1 or cat_l2, as the JAX grower
            # compares them
            vl = -GL / (HL + l2)
            vr = -GR / (HR + l2)
            mc = monotone[None, :, None]
            valid = valid & torch.where(
                mc == 0, True, torch.where(mc > 0, vl <= vr, vl >= vr))
        return torch.where(valid, gain, -torch.inf), CL

    # NaN-bin totals per feature (zero when the feature has no NaN bin,
    # as no categorical feature has)
    nb = torch.clamp(nan_bins, 0, B - 1)
    fidx = torch.arange(FP, device=hist.device)
    nan_tot = hist[:, fidx, nb, :]                     # (K, FP, 3)
    has_nan = (nan_bins < B)[None, :, None]
    nan_tot = torch.where(has_nan, nan_tot, 0.0)

    # default-right: the NaN bin sits at num_bins-1, so cum[t] for t below it
    # excludes it; default-left adds the NaN totals to the left side
    gain_r, CL_r = scan_gains(cum)
    gain_l, CL_l = scan_gains(cum, nan_tot[:, :, None, :])
    use_left = has_nan & (gain_l > gain_r)
    gain = torch.where(use_left, gain_l, gain_r)
    CLsel = torch.where(use_left, CL_l, CL_r)
    if order is not None:
        kk = torch.arange(B, device=hist.device)[None, None, :]
        nu = n_usable[..., None]
        # thin groups sort last and are never candidates; max_cat_threshold
        # caps only the many-vs-many prefix
        valid_k = torch.where(onehot, kk < nu,
                              (kk < cfg.max_cat_threshold) & (kk < nu))
        gain = torch.where(is_cat & ~valid_k, -torch.inf, gain)
        use_left = use_left & ~is_cat              # never default-left
    fmask = feature_mask if feature_mask.dim() == 2 else feature_mask[None]
    gain = torch.where(fmask[:, :, None], gain, -torch.inf)

    flat = gain.reshape(K, FP * B)
    best = torch.argmax(flat, dim=1, keepdim=True)     # first max, as jnp.argmax
    pick = lambda a: torch.gather(a.reshape(K, FP * B), 1, best)[:, 0]
    fsel, bsel = best[:, 0] // B, best[:, 0] % B
    rows = torch.stack([
        pick(gain).double(), fsel.double(), bsel.double(),
        pick(use_left.expand(K, FP, B)).double(),
        pick(CLsel).double(), totals[:, 0].double(), totals[:, 1].double(),
        totals[:, 2].double()], dim=1)
    if order is None:
        return rows
    bits = _winning_bitset(order, fsel, bsel, catb, cfg)
    return torch.cat([rows, bits.double()], dim=1)


def _winning_bitset(order, fsel, bsel, catb, cfg: GrowerConfig):
    """(K, ceil(B / 32)) int64 bitset words (uint32 values) of each leaf's
    winner: the bins at sorted positions ``<= bsel`` of feature ``fsel``
    (one-vs-rest: the one at ``bsel``). As in the JAX package, a numeric
    winner gets the words its feature's bin order would give; a split uses
    them only when its feature is categorical."""
    K, _, B = order.shape
    order_f = order[torch.arange(K, device=order.device), fsel]   # (K, B)
    idx = torch.arange(B, device=order.device)[None, :]
    onehot = (catb[fsel] <= cfg.max_cat_to_onehot)[:, None]
    take = torch.where(onehot, idx == bsel[:, None], idx <= bsel[:, None])
    vals = torch.where(take, torch.ones_like(order_f) << (order_f & 31), 0)
    return torch.zeros((K, -(-B // BITS)), dtype=torch.int64,
                       device=order.device).scatter_add_(1, order_f >> 5, vals)


def _member(bits: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Whether bin ``b`` is in the bitset whose words are ``bits`` (the
    same leading shape as ``b``, words last; int64 lanes of uint32)."""
    w = torch.gather(bits, -1, torch.clamp(b >> 5, 0, bits.shape[-1] - 1)
                     .unsqueeze(-1)).squeeze(-1)
    return ((w >> (b & 31)) & 1) == 1


def _to_host(t: torch.Tensor, stats: Optional[dict]) -> np.ndarray:
    if stats is not None:
        stats["host_syncs"] = stats.get("host_syncs", 0) + 1
    return t.cpu().numpy()


def transpose_bins(binned: torch.Tensor) -> torch.Tensor:
    """(n, F) bins → (FP, n) int32, zero rows for the padded features."""
    n, f = binned.shape
    bT = torch.zeros((features_padded(f), n), dtype=torch.int32,
                     device=binned.device)
    bT[:f] = binned.T.to(torch.int32)
    return bT


# ---------------------------------------------------------------------------
# Tree growth
# ---------------------------------------------------------------------------

def _padded_features(feature_active, nan_bins, FP: int, dev, monotone=None):
    """(featp (FP,) bool, nanp (FP,) i64 on ``dev``, nanp as numpy, monop
    (FP,) i64 on ``dev`` or None): the active mask, each feature's NaN bin
    (``NO_NAN_BIN``: none) and monotone constraint, padded to FP features
    that are inactive, have no NaN bin and no constraint. ``monotone``
    that is None or all zero gives None."""
    f = feature_active.shape[0]
    featp = torch.zeros(FP, dtype=torch.bool, device=dev)
    featp[:f] = feature_active
    nanp_host = np.full(FP, NO_NAN_BIN, np.int64)
    if nan_bins is not None:
        nanp_host[:f] = np.asarray(nan_bins)
    monop = None
    if monotone is not None and np.any(np.asarray(monotone)):
        mono_host = np.zeros(FP, np.int64)
        mono_host[:f] = np.asarray(monotone)
        monop = torch.as_tensor(mono_host, device=dev)
    return featp, torch.as_tensor(nanp_host, device=dev), nanp_host, monop


def _padded_categorical(cfg: GrowerConfig, is_categorical, cat_nbins,
                        FP: int, B: int, dev):
    """(catp (FP,) bool and catb (FP,) i64 on ``dev``, catp as numpy): the
    categorical flags and category counts padded to FP features (not
    categorical, count B); three Nones without ``cfg.has_categorical``."""
    if not cfg.has_categorical:
        return None, None, None
    f = len(is_categorical)
    catp_host = np.zeros(FP, bool)
    catp_host[:f] = is_categorical
    catb_host = np.full(FP, B, np.int64)
    catb_host[:f] = cat_nbins
    return (torch.as_tensor(catp_host, device=dev),
            torch.as_tensor(catb_host, device=dev), catp_host)


def node_masks(cfg: GrowerConfig, featp: torch.Tensor, node_key,
               L: int) -> Optional[torch.Tensor]:
    """(2L - 1, FP) bool feature mask of every node id of one tree for
    ``feature_fraction_bynode`` (None at 1): node ``nid`` folds into the
    tree's key ``node_key`` (two 32-bit words, see ``core.prng``), draws
    one uniform per padded feature and keeps the
    ``max(1, ceil(frac * |featp|))`` lowest among the tree's active
    features (LightGBM's ColSampler::GetByNode; the JAX package's
    ``_node_mask_fn``). One batched draw on ``featp``'s device."""
    if cfg.feature_fraction_bynode >= 1.0:
        return None
    if node_key is None:
        raise ValueError("feature_fraction_bynode < 1 requires node_key")
    FP = featp.shape[0]
    dev = featp.device
    nids = torch.arange(2 * L - 1, dtype=torch.int64, device=dev)
    u = prng.uniform(prng.fold_in(node_key, nids), FP)
    u = torch.where(featp, u, torch.inf)
    frac = torch.tensor(cfg.feature_fraction_bynode, dtype=torch.float32,
                        device=dev)
    keep = torch.clamp_min(torch.ceil(frac * featp.sum().to(torch.float32)),
                           1).to(torch.int64)
    order = torch.argsort(u, dim=1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(FP, device=dev).expand_as(order).contiguous())
    return featp & (ranks < keep)


class _TreeBook:
    """Host bookkeeping of one growing tree, for both growth policies: each
    leaf's best split and [G, H, C] totals (rows of ``_best_for_leaf``), its
    depth and parent, and the tree arrays. Leaf numbering follows LightGBM's
    Tree::Split (see ``split``)."""

    def __init__(self, L: int, B: int, catp: Optional[np.ndarray] = None):
        S = max(L - 1, 1)
        BW = -(-B // BITS)
        self.L, self.B = L, B
        self.catp = catp                              # (FP,) or None
        self.bbits = np.zeros((L, BW), np.uint32)     # best split's bitset
        self.bgain = np.full(L, -np.inf, np.float32)
        self.bfeat = np.zeros(L, np.int64)
        self.bbin = np.zeros(L, np.int64)
        self.bdl = np.zeros(L, bool)
        self.bcl = np.zeros(L, np.float32)
        self.tot = np.zeros((L, 3), np.float32)       # leaf [G, H, C]
        self.depth = np.zeros(L, np.int64)
        self.leaf_parent = np.full(L, -1, np.int64)
        self.leaf_is_right = np.zeros(L, bool)
        self.split_feature = np.zeros(S, np.int32)
        self.split_bin = np.full(S, B - 1, np.int32)
        self.split_gain = np.zeros(S, np.float32)
        self.default_left = np.zeros(S, bool)
        self.split_type = np.zeros(S, np.int32)
        self.cat_bitset = np.zeros((S, BW), np.uint32)
        self.left_child = np.full(S, ~0, np.int32)
        self.right_child = np.full(S, ~0, np.int32)
        self.internal_value = np.zeros(S, np.float32)
        self.internal_count = np.zeros(S, np.int32)
        # each leaf's node id for per-node feature masks: the root's, then
        # 2i / 2i + 1 for the left / right child of split i
        self.mask_id = np.full(L, 2 * (L - 1), np.int64)
        self.num_splits = 0

    def set_best(self, leaves, rows: np.ndarray) -> None:
        """Store (K, 8) ``_best_for_leaf`` rows for ``leaves`` (and the
        bitset words that follow them with categorical features)."""
        self.bgain[leaves] = rows[:, 0]
        self.bfeat[leaves] = rows[:, 1]
        self.bbin[leaves] = rows[:, 2]
        self.bdl[leaves] = rows[:, 3] != 0
        self.bcl[leaves] = rows[:, 4]
        self.tot[leaves] = rows[:, 5:REC]
        if rows.shape[1] > REC:
            self.bbits[leaves] = rows[:, REC:].astype(np.uint32)

    def split(self, l: int, cfg: GrowerConfig) -> int:
        """Apply leaf ``l``'s best split as internal node ``num_splits``:
        the left child keeps leaf id ``l``, the right child becomes leaf
        ``num_splits + 1`` (returned); child pointers use ``~leaf``."""
        i_node = self.num_splits
        new_right = i_node + 1
        p = self.leaf_parent[l]
        if p >= 0:
            if self.leaf_is_right[l]:
                self.right_child[p] = i_node
            else:
                self.left_child[p] = i_node
        self.left_child[i_node] = ~l
        self.right_child[i_node] = ~new_right
        self.split_feature[i_node] = self.bfeat[l]
        self.split_bin[i_node] = self.bbin[l]
        self.split_gain[i_node] = self.bgain[l]
        self.default_left[i_node] = self.bdl[l]
        if self.catp is not None:
            self.split_type[i_node] = int(self.catp[self.bfeat[l]])
            self.cat_bitset[i_node] = self.bbits[l]
        self.internal_value[i_node] = _leaf_output_host(
            self.tot[l, 0], self.tot[l, 1], cfg)
        self.internal_count[i_node] = np.int32(self.tot[l, 2])
        self.depth[new_right] = self.depth[l] + 1
        self.depth[l] += 1
        self.leaf_parent[l] = self.leaf_parent[new_right] = i_node
        self.leaf_is_right[l], self.leaf_is_right[new_right] = False, True
        self.mask_id[l], self.mask_id[new_right] = 2 * i_node, 2 * i_node + 1
        self.num_splits += 1
        return new_right

    def tree(self, hist: torch.Tensor, cfg: GrowerConfig,
             leaf_tot: Optional[torch.Tensor] = None) -> TreeArrays:
        """The grown tree; leaf stats come from the per-leaf histograms
        ``hist`` (L, FP, B, 3) (per-leaf float32 sums), or from the (L, 3)
        ``leaf_tot`` given, and stay on the device."""
        L = self.L
        if leaf_tot is None:
            leaf_tot = _bin_sum(hist[:, 0])            # (L, 3)
        exists = torch.arange(L, device=hist.device) <= self.num_splits
        leaf_value = torch.where(
            exists, _leaf_output(leaf_tot[:, 0], leaf_tot[:, 1], cfg)
            * cfg.learning_rate, 0.0)
        return TreeArrays(
            split_feature=self.split_feature, split_bin=self.split_bin,
            split_gain=self.split_gain, split_type=self.split_type,
            default_left=self.default_left, cat_bitset=self.cat_bitset,
            left_child=self.left_child, right_child=self.right_child,
            internal_value=self.internal_value,
            internal_count=self.internal_count,
            leaf_value=leaf_value, leaf_weight=leaf_tot[:, 1],
            leaf_count=leaf_tot[:, 2].to(torch.int32),
            num_splits=np.int32(self.num_splits))


def _mesh_group(mesh):
    """(the process group of ``mesh``'s data axis, this rank's index on
    it); (None, 0) without a mesh or on a one-rank axis."""
    from ..parallel.mesh import DATA_AXIS

    if mesh is None or int(dict(mesh.shape).get(DATA_AXIS, 1)) <= 1:
        return None, 0
    return mesh.group(DATA_AXIS), mesh.axis_index(DATA_AXIS)


def _check_reduce(cfg: GrowerConfig, group) -> bool:
    """Validate ``hist_reduce`` (the JAX grower's checks); True for the
    feature-parallel scatter mode."""
    if cfg.hist_reduce not in ("allreduce", "scatter"):
        raise ValueError("hist_reduce must be 'allreduce' or 'scatter', "
                         f"got {cfg.hist_reduce!r}")
    if not (cfg.hist_reduce == "scatter" and cfg.feature_shards > 1):
        return False
    if cfg.growth_policy != "leafwise" or cfg.row_layout != "partition":
        raise ValueError(
            "hist_reduce='scatter' (feature-parallel) supports only "
            "leafwise growth with the partition row layout")
    if cfg.has_categorical:
        raise ValueError("hist_reduce='scatter' does not support "
                         "categorical features (the winning split's "
                         "bitset needs the owner's histogram slice)")
    if group is None:
        raise ValueError("hist_reduce='scatter' requires a mesh axis")
    return True


def _exchange_best(rows: np.ndarray, group, off: int) -> np.ndarray:
    """Feature-parallel candidate exchange: every rank's best owned
    candidate per leaf ((K, 8) records, feature indices local to the owned
    slice starting at ``off``) gathered, and per leaf the highest gain
    taken (``np.argmax``: the lowest rank on a tie); the leaf totals
    ``[G, H, C]`` are rank 0's, as the JAX package's replicated output
    is. Every rank returns the same records."""
    t0 = time.perf_counter()
    rows = rows.copy()
    rows[:, 1] += off
    allr = coll.allgather(torch.from_numpy(rows), group).numpy()  # (W, K, 8)
    win = np.argmax(allr[:, :, 0], axis=0)
    out = allr[win, np.arange(rows.shape[0])]
    out[:, 5:REC] = allr[0, :, 5:REC]
    _wire(1, rows.nbytes)
    WIRE["seconds"] += time.perf_counter() - t0
    return out


def grow_tree(binned, grad, hess, in_bag, feature_active, cfg: GrowerConfig,
              nan_bins=None, bT0=None, stats: Optional[dict] = None,
              monotone=None, node_key=None, is_categorical=None,
              cat_nbins=None, mesh=None):
    """Grow one tree; returns (TreeArrays, node_of_row) where node_of_row is
    each row's final leaf index (used for the O(1) training-score update).

    ``binned`` (N, F) bin ids, ``grad``/``hess``/``in_bag`` (N,) float32 and
    ``feature_active`` (F,) bool are tensors on one device; ``nan_bins`` (F,)
    holds each feature's NaN bin (0x7FFF: none). ``bT0`` is the
    ``transpose_bins(binned)`` matrix when the caller keeps one across trees
    (it is not modified). ``stats["host_syncs"]`` counts host reads.
    ``monotone`` (F,) -1/0/+1 constraints (host array or None);
    ``node_key`` the tree's key (``core.prng``) for
    ``feature_fraction_bynode``. With ``cfg.has_categorical``,
    ``is_categorical`` (F,) bool marks the categorical features and
    ``cat_nbins`` (F,) holds their distinct category counts (host arrays).
    ``mesh``: this rank's rows are its block of a tree grown over the
    mesh's ``data`` axis (module docstring); every rank of the axis must
    call with its block and the same other arguments.
    """
    group, rank = _mesh_group(mesh)
    scatter = _check_reduce(cfg, group)
    if cfg.growth_policy == "depthwise":
        from .grower_depthwise import grow_tree_depthwise

        return grow_tree_depthwise(binned, grad, hess, in_bag, feature_active,
                                   cfg, nan_bins=nan_bins, bT0=bT0,
                                   stats=stats, monotone=monotone,
                                   node_key=node_key,
                                   is_categorical=is_categorical,
                                   cat_nbins=cat_nbins, group=group)
    if cfg.growth_policy != "leafwise":
        raise ValueError("growth_policy must be 'leafwise' or 'depthwise', "
                         f"got {cfg.growth_policy!r}")
    layout = cfg.row_layout
    if layout not in ("partition", "masked", "gather"):
        raise ValueError(
            "row_layout must be 'partition', 'masked' or 'gather', "
            f"got {layout!r}")
    n, f = binned.shape
    dev = binned.device
    L = cfg.num_leaves
    B = pad_bins(cfg.num_bins)
    FP = features_padded(f)

    # the partition layout moves the bins with its rows; the others only
    # read them
    bT = transpose_bins(binned) if bT0 is None else bT0
    if layout == "partition" and bT0 is not None:
        bT = bT.clone()
    in_bag = in_bag.to(torch.float32)
    gs = grad.to(torch.float32) * in_bag
    hs = hess.to(torch.float32) * in_bag
    ms = in_bag.clone()
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    node = (torch.zeros(n, dtype=torch.int64, device=dev)
            if layout == "masked" else None)
    segmented = cfg.use_segmented is None or bool(cfg.use_segmented)
    featp, nanp, nanp_host, monop = _padded_features(
        feature_active, nan_bins, FP, dev, monotone)
    catp, catb, catp_host = _padded_categorical(cfg, is_categorical,
                                                cat_nbins, FP, B, dev)
    masks = node_masks(cfg, featp, node_key, L)
    # feature-parallel: this rank's histograms and split search cover its
    # owned features [off, off + FPo) only
    W = cfg.feature_shards if scatter else 1
    if FP % W:
        raise ValueError(f"hist_reduce='scatter' needs features_padded({f})="
                         f"{FP} divisible by feature_shards={W}")
    FPo, off = FP // W, rank * (FP // W) if scatter else 0
    own = slice(off, off + FPo)
    nanp_o = nanp[own]
    monop_o = None if monop is None else monop[own]

    def mask_of(i: int, count: int = 1):
        """The masks of node ids ``i .. i + count - 1`` (the tree's mask
        without per-node sampling), on the owned features."""
        return (featp if masks is None else masks[i:i + count])[..., own]

    def reduce(h):
        if scatter:
            return _hist_reduce_scatter(h, group, cfg.hist_allreduce_dtype)
        return _maybe_psum(h, group, cfg.hist_allreduce_dtype)

    def best_rows(rows: np.ndarray) -> np.ndarray:
        return _exchange_best(rows, group, off) if scatter else rows

    hist = torch.zeros((L, FPo, B, 3), dtype=torch.float32, device=dev)
    hist[0] = reduce(child_histogram(bT, gs, hs, ms, B))
    book = _TreeBook(L, B, catp_host)
    root = _best_for_leaf(hist[:1], mask_of(2 * (L - 1)), nanp_o, cfg,
                          monop_o, catp, catb)
    # each leaf's best bitset also stays on the device for the partition
    dbits = (torch.zeros((L, root.shape[1] - REC), dtype=torch.int64,
                         device=dev) if catp is not None else None)
    if dbits is not None:
        dbits[0] = root[0, REC:].to(torch.int64)
    book.set_best([0], best_rows(_to_host(root, stats)))
    leaf_start = np.zeros(L, np.int64)
    leaf_len = np.zeros(L, np.int64)
    leaf_len[0] = n
    min_gain = np.float32(cfg.min_gain_to_split)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    for _ in range(L - 1):
        active = np.arange(L) <= book.num_splits
        if cfg.max_depth > 0:
            active &= book.depth < cfg.max_depth
        masked = np.where(active, book.bgain, np.float32(-np.inf))
        l = int(np.argmax(masked))
        if not masked[l] > min_gain:
            break
        fsel, bsel, dl = int(book.bfeat[l]), int(book.bbin[l]), bool(book.bdl[l])
        start, length = int(leaf_start[l]), int(leaf_len[l])
        end = start + length

        def go_right(binrow):
            """Whether each row of ``binrow`` (its bins of feature fsel)
            goes to the right child."""
            if catp_host is not None and catp_host[fsel]:
                return ~_member(dbits[l].expand(binrow.shape[0], -1),
                                binrow.to(torch.int64))
            gr = binrow > bsel
            if nanp_host[fsel] < B:
                is_nan = binrow == int(nanp_host[fsel])
                gr = (gr & ~is_nan) if dl else (gr | is_nan)
            return gr

        # build the smaller child (decided from the best split's global
        # count-left), the sibling is parent - child
        left_small = book.bcl[l] * np.float32(2.0) <= book.tot[l, 2]
        a = 0 if left_small else 1
        if layout == "masked":
            # route leaf l's rows: the right-goers become leaf num_splits + 1
            new_id = book.num_splits + 1
            node = torch.where((node == l) & go_right(bT[fsel]), new_id, node)
            sel = (node == (new_id if a else l)).to(torch.float32)
            hist_small = child_histogram(bT, gs * sel, hs * sel, ms * sel, B)
            nl_loc = zero
        else:
            # stable partition of the leaf's range: left-going rows first
            posl = pos[start:end]
            binrow = (bT[fsel, start:end] if layout == "partition"
                      else bT[fsel][posl])
            gr = go_right(binrow)
            src = stable_partition_src(gr.to(torch.int64),
                                       cfg.partition_impl)
            nl_loc = length - gr.sum()
            pos[start:end] = posl[src]
            if layout == "partition":
                gs[start:end] = gs[start:end][src]
                hs[start:end] = hs[start:end][src]
                ms[start:end] = ms[start:end][src]
                bT[:, start:end] = bT[:, start:end][:, src]
                child_start = nl_loc * a + start
                child_len = nl_loc * (1 - 2 * a) + length * a
                if segmented:
                    hist_small = range_histogram(bT, gs, hs, ms, child_start,
                                                 child_len, B)
                else:
                    # a window of the sorted rows aligned down to CHUNK,
                    # holding the child, with its range mask
                    cs = start // CHUNK * CHUNK
                    idx = torch.arange(cs, end, device=dev)
                    win = ((idx >= child_start)
                           & (idx < child_start + child_len)).to(torch.float32)
                    hist_small = child_histogram(
                        bT[:, cs:end].contiguous(), gs[cs:end] * win,
                        hs[cs:end] * win, ms[cs:end] * win, B)
            else:
                # gather: the child's rows through pos, in original order
                # within the leaf; its row count is read first
                nl = int(_to_host(nl_loc, stats))
                c0, c1 = ((start, start + nl) if left_small
                          else (start + nl, end))
                rows = pos[c0:c1]
                hist_small = child_histogram(
                    bT.index_select(1, rows), gs[rows], hs[rows], ms[rows], B)
        hist_small = reduce(hist_small)
        hist_parent = hist[l]
        hist_left = hist_small if left_small else hist_parent - hist_small
        hist_right = hist_parent - hist_left
        children = torch.stack([hist_left, hist_right])
        best2 = _best_for_leaf(children, mask_of(2 * book.num_splits, 2),
                               nanp_o, cfg, monop_o, catp, catb)
        rec = _to_host(torch.cat([nl_loc.reshape(1).double(),
                                  best2.reshape(-1)]), stats)
        new_right = book.split(l, cfg)
        hist[l] = children[0]
        hist[new_right] = children[1]
        if dbits is not None:
            dbits[l] = best2[0, REC:].to(torch.int64)
            dbits[new_right] = best2[1, REC:].to(torch.int64)
        book.set_best([l, new_right], best_rows(rec[1:].reshape(2, -1)))
        nl = int(rec[0])
        leaf_start[new_right] = start + nl
        leaf_len[l], leaf_len[new_right] = nl, length - nl

    leaf_tot = None
    if scatter:
        t0 = time.perf_counter()
        leaf_tot = coll.allgather(_bin_sum(hist[:, 0]), group)[0]
        _wire(1, _nbytes(leaf_tot))
        WIRE["seconds"] += time.perf_counter() - t0
    tree = book.tree(hist, cfg, leaf_tot)
    if node is not None:
        return tree, node

    # each row's leaf, in original row order, from the leaf ranges
    node_sorted = torch.empty(n, dtype=torch.int64, device=dev)
    for leaf in range(book.num_splits + 1):
        s0, ln = int(leaf_start[leaf]), int(leaf_len[leaf])
        if ln > 0:
            node_sorted[s0:s0 + ln] = leaf
    node_of_row = torch.empty_like(node_sorted)
    node_of_row[pos] = node_sorted
    return tree, node_of_row


# ---------------------------------------------------------------------------
# Stacked-forest prediction
# ---------------------------------------------------------------------------

class Forest(NamedTuple):
    """All trees stacked on a leading tree axis, as device tensors;
    ``threshold`` is in raw feature space."""

    split_feature: torch.Tensor  # (T, L-1) i64
    threshold: torch.Tensor      # (T, L-1) f32
    split_bin: torch.Tensor      # (T, L-1) i64 (binned traversal)
    split_type: torch.Tensor     # (T, L-1) i64
    default_left: torch.Tensor   # (T, L-1) bool
    cat_bitset: torch.Tensor     # (T, L-1, BW) i64 (uint32 words)
    left_child: torch.Tensor     # (T, L-1) i64
    right_child: torch.Tensor    # (T, L-1) i64
    leaf_value: torch.Tensor     # (T, L) f32
    missing_type: torch.Tensor   # (T, L-1) i64: 0 none, 1 zero, 2 nan

    @property
    def num_trees(self) -> int:
        return self.split_feature.shape[0]


def stack_trees(trees: list, thresholds: list, missing_types: list,
                device) -> Forest:
    """Host-side: stack per-tree TreeArrays (+ real-valued thresholds and
    LightGBM missing-type codes per split) into a device Forest."""
    def cat(field, dtype):
        return torch.as_tensor(np.stack(
            [np.asarray(getattr(t, field)).astype(dtype) for t in trees]),
            device=device)

    return Forest(
        split_feature=cat("split_feature", np.int64),
        threshold=torch.as_tensor(np.stack(
            [np.asarray(t, np.float32) for t in thresholds]), device=device),
        split_bin=cat("split_bin", np.int64),
        split_type=cat("split_type", np.int64),
        default_left=cat("default_left", bool),
        cat_bitset=cat("cat_bitset", np.int64),
        left_child=cat("left_child", np.int64),
        right_child=cat("right_child", np.int64),
        leaf_value=cat("leaf_value", np.float32),
        missing_type=torch.as_tensor(np.stack(
            [np.asarray(m, np.int64) for m in missing_types]), device=device),
    )


def _descend(forest: Forest, X: torch.Tensor, depth: int,
             nan_bins: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vectorized pointer-chase of every tree at once: (N, F) → (N, T) leaf
    indices (LightGBM Tree::NumericalDecision / CategoricalDecision). With
    ``nan_bins`` (F,) ``X`` holds bins: a bin ``> split_bin`` goes right, a
    row in its feature's NaN bin takes the split's default side, and a
    categorical split tests the bin against its bitset."""
    T, S = forest.split_feature.shape
    BW = forest.cat_bitset.shape[2]
    dev = X.device
    base = (torch.arange(T, device=dev) * S)[None, :]
    sf = forest.split_feature.reshape(-1)
    thr = forest.threshold.reshape(-1)
    sbin = forest.split_bin.reshape(-1)
    stype = forest.split_type.reshape(-1)
    dleft = forest.default_left.reshape(-1)
    bits = forest.cat_bitset.reshape(-1)
    lc = forest.left_child.reshape(-1)
    rc = forest.right_child.reshape(-1)
    mts = forest.missing_type.reshape(-1)
    node = torch.zeros((X.shape[0], T), dtype=torch.int64, device=dev)
    for _ in range(depth):
        nd = torch.clamp_min(node, 0) + base
        f = sf[nd]
        x = torch.gather(X, 1, f)
        dl = dleft[nd]
        if nan_bins is not None:
            c = x.to(torch.int64)
            num_right = torch.where(c == nan_bins[f], ~dl, c > sbin[nd])
        else:
            mt = mts[nd]
            # NaN coerces to 0.0 unless missing_type is nan; zero missing
            # routes |x| <= 1e-35 to the default side (kZeroThreshold)
            isnan_x = torch.isnan(x)
            x0 = torch.where(isnan_x & (mt != 2), 0.0, x)
            is_missing = torch.where(mt == 1, torch.abs(x0) <= 1e-35,
                                     (mt == 2) & isnan_x)
            num_right = torch.where(is_missing, ~dl, ~(x0 <= thr[nd]))
            # categorical NaN: member test on category 0 unless
            # missing_type is nan, where NaN is never a member
            cat_nan = torch.where(mt == 2, -1.0, 0.0)
            c = torch.clamp(torch.where(isnan_x, cat_nan, x), -1,
                            BW * BITS - 1).to(torch.int64)
        cw = torch.clamp_min(c, 0)
        word = bits[nd * BW + torch.clamp(cw >> 5, max=BW - 1)]
        member = (((word >> (cw & 31)) & 1) == 1) & (c >= 0)
        go_right = torch.where(stype[nd] == 1, ~member, num_right)
        nxt = torch.where(go_right, rc[nd], lc[nd])
        node = torch.where(node < 0, node, nxt)
    return ~node


def _tree_window(forest: Forest, t0: int, t1: int) -> Forest:
    """Trees ``t0..t1-1`` of ``forest`` (views)."""
    if t0 == 0 and t1 == forest.num_trees:
        return forest
    return Forest(*(a[t0:t1] for a in forest))


def _chunk_rows(T: int, rows_per_chunk: Optional[int]) -> int:
    """Rows per chunk, keeping a (rows, T) temporary near 16M elements."""
    return rows_per_chunk or max(1, (1 << 24) // max(T, 1))


def forest_predict(forest: Forest, X: torch.Tensor, depth: int,
                   rows_per_chunk: Optional[int] = None,
                   num_class: int = 1, start_iteration: int = 0,
                   num_iteration: int = -1,
                   nan_bins: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, num_class) float32 sum of tree outputs per row: tree ``t``
    belongs to class ``t % num_class`` (iteration-major order), and each
    class sums its trees in iteration order (as the JAX scan does). Only
    iterations ``start_iteration`` .. ``start_iteration + num_iteration - 1``
    count (``num_iteration <= 0``: through the last). Rows go in chunks so
    the (rows, T) temporaries stay near 16M elements. ``nan_bins``: ``X``
    holds bins (``_descend``)."""
    k = num_class
    t0 = min(max(int(start_iteration), 0) * k, forest.num_trees)
    t1 = forest.num_trees
    if num_iteration and num_iteration > 0:
        t1 = min(t1, t0 + int(num_iteration) * k)
    out = torch.zeros((X.shape[0], k), dtype=torch.float32, device=X.device)
    if t1 <= t0:
        return out
    forest = _tree_window(forest, t0, t1)
    T = t1 - t0
    L = forest.leaf_value.shape[1]
    depth = max(int(depth), 1)
    step = _chunk_rows(T, rows_per_chunk)
    lv = forest.leaf_value.reshape(-1)
    tbase = (torch.arange(T, device=X.device) * L)[None, :]
    for s in range(0, X.shape[0], step):
        vals = lv[_descend(forest, X[s:s + step], depth, nan_bins)
                  + tbase]                                       # (r, T)
        total = torch.zeros((vals.shape[0], k), dtype=torch.float32,
                            device=X.device)
        for t in range(0, T, k):
            total = total + vals[:, t:t + k]
        out[s:s + step] = total
    return out


def forest_leaves(forest: Forest, X: torch.Tensor, depth: int,
                  start_tree: int = 0) -> torch.Tensor:
    """(N, T - start_tree) int32 leaf index of every row in trees
    ``start_tree`` onward (predictLeaf), in row chunks."""
    forest = _tree_window(forest, min(start_tree, forest.num_trees),
                          forest.num_trees)
    T = forest.num_trees
    out = torch.empty((X.shape[0], T), dtype=torch.int32, device=X.device)
    if T == 0:
        return out
    step = _chunk_rows(T, None)
    for s in range(0, X.shape[0], step):
        out[s:s + step] = _descend(forest, X[s:s + step],
                                   max(int(depth), 1)).to(torch.int32)
    return out


def tree_leaves_binned(tree: TreeArrays, binned: torch.Tensor,
                       nan_bins: torch.Tensor) -> torch.Tensor:
    """(N,) leaf index of each binned row in one grown tree: bin
    ``> split_bin`` goes right, a row in its feature's NaN bin
    (``nan_bins`` (F,) on ``binned``'s device) takes the split's default
    side, a categorical split sends the bins outside its bitset right. The
    JAX package's ``_tree_assign_binned``; it scores validation rows tree
    by tree (one upload of the tree's arrays)."""
    ns = int(tree.num_splits)
    dev = binned.device
    node = torch.zeros(binned.shape[0], dtype=torch.int64, device=dev)
    if ns == 0:
        return node
    fields = np.stack([
        np.asarray(getattr(tree, f))[:ns].astype(np.int64)
        for f in ("split_feature", "split_bin", "default_left",
                  "left_child", "right_child", "split_type")])
    bits_host = np.asarray(tree.cat_bitset)[:ns].astype(np.int64)
    packed = torch.as_tensor(np.concatenate([fields, bits_host.T]),
                             device=dev)
    sf, sbin, dl, lc, rc, stype = packed[:6]
    bits = packed[6:].T
    has_cat = bool((fields[5] == 1).any())
    for _ in range(forest_max_depth([tree])):
        nd = torch.clamp_min(node, 0)
        f = sf[nd]
        xb = torch.gather(binned, 1, f[:, None])[:, 0].to(torch.int64)
        go_right = torch.where(xb == nan_bins[f], dl[nd] == 0, xb > sbin[nd])
        if has_cat:
            go_right = torch.where(stype[nd] == 1, ~_member(bits[nd], xb),
                                   go_right)
        nxt = torch.where(go_right, rc[nd], lc[nd])
        node = torch.where(node < 0, node, nxt)
    return ~node


def forest_max_depth(trees: list) -> int:
    """Max internal-node depth across trees (host-side): the exact number of
    pointer-chase steps any row needs."""
    maxd = 1
    for t in trees:
        ns = int(t.num_splits)
        if ns <= 0:
            continue
        lc = np.asarray(t.left_child)[:ns]
        rc = np.asarray(t.right_child)[:ns]
        depth = np.ones(ns, np.int64)
        stack = [0]
        while stack:
            i = stack.pop()
            for c in (lc[i], rc[i]):
                if 0 <= c < ns:
                    depth[c] = depth[i] + 1
                    stack.append(int(c))
        maxd = max(maxd, int(depth.max()))
    return maxd
