"""Voting-parallel feature selection (PV-Tree) and the distributed GBDT's
collective cost model.

Counterpart of the JAX package's ``gbdt/voting.py``. LightGBM's
``voting_parallel`` learner (``parallelism``/``topK``): every rank votes
its local top-k features by root split gain, the global top-2k by votes
(gain sum breaking ties) are elected, and the tree grows on those columns
only, so each split's histogram reduction moves 2k features instead of F.
Here the election runs once per tree at the root over each rank's block of
rows (``voting_select``: one float32 sum of the votes and the gain sums);
the tree grows on the elected columns and ``remap_tree_features`` maps its
split features back to the full feature space.

The cost model (``voting_cost_model``, ``recommend_tree_learner``,
``route_parallelism``) is the JAX package's, term for term, so that given
the same measured inputs it makes the same choice. Its one recorded input,
the engine throughput anchor behind the selection-cost estimate, is the JAX
package's fallback constant (``DEFAULT_ENGINE_ROW_ITERS_PER_S``); the
port reads none of the JAX package's recorded measurements (they were taken
on TPUs), and on a mesh the router measures the selection pass instead.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..parallel import collectives as coll
from ..parallel.mesh import DATA_AXIS

# per-rank row budget of the selection pass: a strided subsample (not a
# prefix, so label-sorted rows stay representative), its contributions
# scaled back by the stride
DEFAULT_SELECTION_SAMPLE_ROWS = 4096


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest values, ties to the lower index (as
    ``lax.top_k``)."""
    return torch.argsort(-x, stable=True)[:k]


def _per_feature_root_gain(binned, g, h, in_bag, num_bins: int,
                           lambda_l2: float, min_data: int) -> torch.Tensor:
    """(F,) best numeric-split gain of each feature at the root over this
    rank's rows (``binned`` (n, F)); counts come from ``in_bag``, so padding
    and bagged-out rows do not pass the ``min_data`` filter."""
    n, f = binned.shape
    dev = binned.device
    b = binned.to(torch.int64)
    flat = b + torch.arange(f, device=dev)[None, :] * num_bins
    flat = torch.where((b >= 0) & (b < num_bins), flat, f * num_bins)
    contrib = torch.stack([g, h, in_bag], dim=1).to(torch.float32)  # (n, 3)
    tot = torch.zeros((f * num_bins + 1, 3), dtype=torch.float32, device=dev)
    tot.index_add_(0, flat.reshape(-1),
                   contrib[:, None, :].expand(n, f, 3).reshape(-1, 3))
    hist = tot[:-1].reshape(f, num_bins, 3)
    cum = torch.cumsum(hist, dim=1)
    G, H = cum[:, -1, 0:1], cum[:, -1, 1:2]
    GL, HL, CL = cum[..., 0], cum[..., 1], cum[..., 2]
    GR, HR, CR = G - GL, H - HL, cum[:, -1, 2:3] - CL
    lam = float(np.float32(lambda_l2))
    gain = GL ** 2 / (HL + lam) + GR ** 2 / (HR + lam) - G ** 2 / (H + lam)
    valid = (CL >= min_data) & (CR >= min_data)
    return torch.where(valid, gain, -torch.inf).amax(dim=1)


def _selection_stride(n: int, mesh, sample_rows) -> int:
    """Subsample stride of the selection pass over a rank's block of a
    ``n``-row (padded, global) table."""
    if sample_rows is None:
        sample_rows = DEFAULT_SELECTION_SAMPLE_ROWS
    if sample_rows <= 0:
        return 1
    shard_rows = max(n // int(dict(mesh.shape).get(DATA_AXIS, 1)), 1)
    return max(-(-shard_rows // int(sample_rows)), 1)


def voting_select(binned, g, h, in_bag, mesh, top_k: int, num_bins: int,
                  lambda_l2: float = 0.0, min_data: int = 1,
                  feature_active=None, sample_rows=None) -> np.ndarray:
    """Sorted int64 indices of the global top-2k features (or fewer) by the
    ranks' votes, the same on every rank. Every rank of ``mesh``'s data
    axis calls it with its own block: ``binned`` (n_block, F) and
    ``g``/``h``/``in_bag`` (n_block,) on one device. ``feature_active``
    (F,) bool restricts the vote to the tree's feature sample;
    ``sample_rows`` caps the rows each rank scans (default
    ``DEFAULT_SELECTION_SAMPLE_ROWS``; <= 0 scans all)."""
    n_block, f = binned.shape
    k = min(top_k, f)
    out_k = min(2 * k, f)
    dev = binned.device
    active = (torch.ones(f, dtype=torch.bool, device=dev)
              if feature_active is None
              else torch.as_tensor(feature_active).to(dev, torch.bool))
    n = n_block * int(dict(mesh.shape).get(DATA_AXIS, 1))
    stride = _selection_stride(n, mesh, sample_rows)
    if stride > 1:
        # scaled by the stride, the sums keep their G / H / count scale
        binned, g, h, in_bag = (binned[::stride], g[::stride] * float(stride),
                                h[::stride] * float(stride),
                                in_bag[::stride] * float(stride))
    local = _per_feature_root_gain(binned, g, h, in_bag, num_bins, lambda_l2,
                                   min_data)
    local = torch.where(active, local, -torch.inf)
    votes = torch.zeros(f, dtype=torch.float32, device=dev)
    votes[_top_k(local, k)] += 1.0
    finite = torch.where(torch.isfinite(local), local, 0.0)
    # the votes and the gain sums in one sum over the ranks
    votes, gain_sum = coll.allreduce_sum(torch.stack([votes, finite]),
                                         mesh.group(DATA_AXIS))
    # votes dominate, the normalised gain sum breaks their ties
    norm = gain_sum / (gain_sum.abs().max() + 1e-12)
    score = torch.where(active, votes * 2.0 + norm, -torch.inf)
    return torch.sort(_top_k(score, out_k)).values.cpu().numpy()


def time_selection(binned, mesh, top_k: int, num_bins: int,
                   lambda_l2: float = 0.0, min_data: int = 1,
                   sample_rows=None) -> tuple:
    """(seconds of one selection pass, fraction of a rank's rows it scans)
    on this rank's block ``binned`` with unit gradients, after one warm-up;
    the ranks' seconds are agreed by a MAX all-reduce, so every rank
    returns the same value (the router then decides alike everywhere)."""
    n_block = binned.shape[0]
    ones = torch.ones(n_block, dtype=torch.float32, device=binned.device)

    def once() -> float:
        if binned.is_cuda:
            torch.cuda.synchronize(binned.device)
        t0 = time.perf_counter()
        voting_select(binned, ones, ones, ones, mesh, top_k, num_bins,
                      lambda_l2, min_data, sample_rows=sample_rows)
        return time.perf_counter() - t0

    once()
    dt = float(coll.allreduce_max(
        torch.tensor([once()], dtype=torch.float64),
        mesh.group(DATA_AXIS))[0])
    n = n_block * int(dict(mesh.shape).get(DATA_AXIS, 1))
    return dt, 1.0 / _selection_stride(n, mesh, sample_rows)


def remap_tree_features(tree, sel_idx: np.ndarray):
    """A tree grown on the elected columns with its split features mapped
    back to the full feature space."""
    sel = np.asarray(sel_idx, np.int32)
    return tree._replace(split_feature=sel[np.asarray(tree.split_feature)])


# ---------------------------------------------------------------------------
# Collective cost model — when does voting-parallel pay? (the JAX package's)
# ---------------------------------------------------------------------------

# per-link full-duplex bandwidth, bytes/s (public figures the JAX package
# uses as defaults for a link it has not measured)
DEFAULT_LINK_BYTES_PER_S = {"ici": 1.0e11, "dcn": 1.25e10}
# the selection pass as a fraction of one tree's compute (one extra root
# histogram over all features)
DEFAULT_SELECTION_FRACTION = 0.3
# the JAX package's fallback engine throughput (row-iterations per second
# per device); kept so the static model decides as the JAX package's does
DEFAULT_ENGINE_ROW_ITERS_PER_S = 1.69e6
# effective wire bytes per histogram element of each hist_allreduce_dtype
WIRE_DTYPE_BYTES = {"f32": 4.0, "bf16": 8.0 / 3.0, "int8": 2.0}
# share of a full-width histogram pass spent scanning (feature, bin) cells
# for split gains (the feature learner scans its owned 1/W of them)
FEATURE_SCAN_FRACTION = 0.10


def default_engine_row_iters_per_s() -> float:
    """The engine throughput anchor of the selection-cost estimate:
    ``DEFAULT_ENGINE_ROW_ITERS_PER_S`` (the port reads no recorded
    measurement)."""
    return DEFAULT_ENGINE_ROW_ITERS_PER_S


def collective_bytes_per_split(num_features: int, max_bin: int,
                               top_k=None, dtype_bytes: int = 4) -> int:
    """Logical all-reduce payload of ONE split's histogram aggregation:
    (F aggregated, max_bin, 3 channels) x ``dtype_bytes``; data-parallel
    aggregates every feature, voting the elected 2k."""
    f_agg = (num_features if top_k is None
             else min(2 * int(top_k), num_features))
    return int(round(f_agg * int(max_bin) * 3 * dtype_bytes))


def selection_bytes_per_tree(num_features: int, dtype_bytes: int = 4) -> int:
    """The election sums (F,) votes and (F,) gain sums once per tree."""
    return int(num_features) * 2 * dtype_bytes


def voting_cost_model(num_features: int, max_bin: int, top_k: int,
                      num_leaves: int,
                      selection_s_per_tree: float = 1e-3,
                      dtype_bytes: float = 4) -> dict:
    """Per-tree collective bytes of both modes and the crossover link
    bandwidth below which voting's byte saving outweighs its selection
    pass."""
    splits = max(int(num_leaves) - 1, 1)
    dp = splits * collective_bytes_per_split(num_features, max_bin,
                                             dtype_bytes=dtype_bytes)
    vp = (splits * collective_bytes_per_split(num_features, max_bin, top_k,
                                              dtype_bytes=dtype_bytes)
          + selection_bytes_per_tree(num_features))
    saved = max(dp - vp, 0)
    crossover = (saved / selection_s_per_tree
                 if selection_s_per_tree > 0 else float("inf"))
    return {
        "bytes_per_split_data_parallel":
            collective_bytes_per_split(num_features, max_bin,
                                       dtype_bytes=dtype_bytes),
        "bytes_per_split_voting":
            collective_bytes_per_split(num_features, max_bin, top_k,
                                       dtype_bytes=dtype_bytes),
        "selection_bytes_per_tree": selection_bytes_per_tree(num_features),
        "bytes_per_tree_data_parallel": dp,
        "bytes_per_tree_voting": vp,
        "bytes_saved_per_tree": saved,
        "crossover_link_bytes_per_s": crossover,
    }


def recommend_tree_learner(num_features: int, max_bin: int, top_k: int,
                           num_leaves: int, n_hosts: int,
                           rows_per_host: int = None,
                           link_bytes_per_s: float = None,
                           engine_row_iters_per_s: float = None,
                           selection_fraction: float =
                           DEFAULT_SELECTION_FRACTION,
                           selection_s_per_tree: float = None,
                           dtype_bytes: float = 4) -> str:
    """The static byte rule: "data" on one host or when F <= 2k; across
    hosts "voting" iff the per-tree wire seconds it saves exceed its
    selection cost (measured, or ``selection_fraction`` of a
    ``rows_per_host`` pass at the engine throughput)."""
    if n_hosts <= 1 or num_features <= 2 * top_k:
        return "data"
    if link_bytes_per_s is None:
        link_bytes_per_s = DEFAULT_LINK_BYTES_PER_S["dcn"]
    if engine_row_iters_per_s is None:
        engine_row_iters_per_s = default_engine_row_iters_per_s()
    if selection_s_per_tree is None:
        if rows_per_host is None:
            rows_per_host = 1_000_000
        selection_s_per_tree = (selection_fraction * rows_per_host
                                / engine_row_iters_per_s)
    m = voting_cost_model(num_features, max_bin, top_k, num_leaves,
                          selection_s_per_tree, dtype_bytes=dtype_bytes)
    saved_wire_s = m["bytes_saved_per_tree"] / link_bytes_per_s
    return "voting" if saved_wire_s > selection_s_per_tree else "data"


def route_parallelism(num_features: int, max_bin: int, top_k: int,
                      num_leaves: int, *, n_workers: int,
                      rows_per_worker: int, link_bytes_per_s: float,
                      selection_s_per_tree: float = None,
                      selection_fraction_of_rows: float = 1.0,
                      wire_dtype: str = "f32",
                      feature_parallel_ok: bool = False,
                      hist_passes_per_tree: float = None,
                      scan_fraction_of_pass: float = None,
                      engine_row_iters_per_s: float = None) -> tuple:
    """The measured-input router across data, voting and feature: per-tree
    seconds of each as compute (``hist_passes_per_tree`` full-width root
    passes, each ``selection_s_per_tree / selection_fraction_of_rows``;
    voting's passes at its elected width plus its selection pass, the
    feature learner's less its unowned share of the split scan) plus wire
    (its bytes at ``wire_dtype`` over the link). A 5% hysteresis keeps
    "data" on a marginal win. Returns ``(choice, info)``, ``info`` the
    inputs, the predictions and the byte accounting
    (``Booster.metadata["routing"]``)."""
    from ..ops.hist_kernel import features_padded

    db = WIRE_DTYPE_BYTES.get(wire_dtype, 4.0)
    splits = max(int(num_leaves) - 1, 1)
    if hist_passes_per_tree is None:
        hist_passes_per_tree = 1.0 + 0.5 * math.log2(max(num_leaves, 2))
    if selection_s_per_tree is None or selection_s_per_tree <= 0:
        if engine_row_iters_per_s is None:
            engine_row_iters_per_s = default_engine_row_iters_per_s()
        selection_s_per_tree = (DEFAULT_SELECTION_FRACTION * rows_per_worker
                                / engine_row_iters_per_s)
        selection_fraction_of_rows = DEFAULT_SELECTION_FRACTION
    t_root_full = selection_s_per_tree / max(selection_fraction_of_rows,
                                             1e-9)
    t_hist_full = hist_passes_per_tree * t_root_full
    m = voting_cost_model(num_features, max_bin, top_k, num_leaves,
                          selection_s_per_tree, dtype_bytes=db)

    def wire(nbytes):
        return nbytes / max(link_bytes_per_s, 1.0)

    fp_ratio = (features_padded(min(2 * top_k, num_features))
                / max(features_padded(num_features), 1))
    if scan_fraction_of_pass is None:
        scan_fraction_of_pass = FEATURE_SCAN_FRACTION
    scatter_compute = 1.0 - scan_fraction_of_pass * (1.0
                                                     - 1.0 / max(n_workers, 1))
    exchange_bytes = splits * n_workers * 5 * 4
    predicted = {
        "data": t_hist_full + wire(m["bytes_per_tree_data_parallel"]),
        "voting": (selection_s_per_tree + t_hist_full * fp_ratio
                   + wire(m["bytes_per_tree_voting"])),
        "feature": (t_hist_full * scatter_compute
                    + wire(0.5 * m["bytes_per_tree_data_parallel"]
                           + exchange_bytes)),
    }
    candidates = {"data": predicted["data"]}
    if num_features > 2 * top_k and n_workers > 1:
        candidates["voting"] = predicted["voting"]
    if feature_parallel_ok and n_workers > 1:
        candidates["feature"] = predicted["feature"]
    choice = min(candidates, key=candidates.get)
    if choice != "data" and candidates[choice] > 0.95 * candidates["data"]:
        choice = "data"
    info = {
        "tree_learner": choice,
        "predicted_s_per_tree": predicted,
        "considered": sorted(candidates),
        "inputs": {
            "num_features": int(num_features), "max_bin": int(max_bin),
            "top_k": int(top_k), "num_leaves": int(num_leaves),
            "n_workers": int(n_workers),
            "rows_per_worker": int(rows_per_worker),
            "link_bytes_per_s": float(link_bytes_per_s),
            "selection_s_per_tree": float(selection_s_per_tree),
            "selection_fraction_of_rows": float(selection_fraction_of_rows),
            "wire_dtype": wire_dtype, "wire_dtype_bytes": db,
            "hist_passes_per_tree": float(hist_passes_per_tree),
            "scan_fraction_of_pass": float(scan_fraction_of_pass),
        },
        "cost_model": m,
    }
    return choice, info
