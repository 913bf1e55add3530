"""Per-leaf gradient/hessian histograms as one scatter-add.

The port's counterpart of the JAX package's ``ops/histogram.py``: each row
adds its (grad, hess, 1) triple to its bin of every feature, in the leaf
the row sits in. The JAX package writes it as one XLA scatter-add (plain
``jnp``, not a Pallas kernel); here it is one ``index_put_`` with
``accumulate=True`` on flat (leaf, feature, bin) indices, on whatever
device the inputs are on.

Dropped rows and bins: a row whose leaf is negative or at least
``num_leaves`` adds nothing, and neither does a bin outside
``[0, num_bins)``. That is the JAX function's documented contract (its
``mode="drop"``); its scatter wraps a negative leaf or bin to the last one
instead, which no caller relies on (padding and bagged-out rows carry a
negative leaf to be dropped).

:func:`sharded_histogram_fn` is the row-sharded form on the port's mesh:
each rank sums its block of the rows, and ``collectives.allreduce_sum``
folds the partials in rank order, as XLA's CPU all-reduce folds its
devices, so every rank holds the same histogram.
"""

from __future__ import annotations

import torch

from ..parallel import collectives
from ..parallel.mesh import DATA_AXIS, row_block


def leaf_histograms(binned: torch.Tensor, node_of_row: torch.Tensor,
                    grad: torch.Tensor, hess: torch.Tensor, num_leaves: int,
                    num_bins: int) -> torch.Tensor:
    """``(num_leaves, F, num_bins, 3)`` float32 per-leaf, per-feature
    histograms of ``[sum_grad, sum_hess, count]``.

    ``binned`` ``(N, F)`` integer bin ids, ``node_of_row`` ``(N,)`` the
    leaf of each row, ``grad``/``hess`` ``(N,)`` float32, all on one
    device. Rows of a leaf outside ``[0, num_leaves)`` and bins outside
    ``[0, num_bins)`` are dropped."""
    n, f = binned.shape
    dev = binned.device
    bins = binned.to(torch.int64)
    node = node_of_row.to(device=dev, dtype=torch.int64)[:, None]
    keep = ((node >= 0) & (node < num_leaves) & (bins >= 0)
            & (bins < num_bins))                                  # (N, F)
    feat = torch.arange(f, device=dev, dtype=torch.int64)[None, :]
    cell = (node * f + feat) * num_bins + bins                    # (N, F)
    vals = torch.stack([grad.to(torch.float32), hess.to(torch.float32),
                        torch.ones(n, dtype=torch.float32, device=dev)],
                       dim=-1)                                    # (N, 3)
    vals = vals[:, None, :].expand(n, f, 3)[keep]                 # (K, 3)
    idx = cell[keep]
    hist = torch.zeros((num_leaves * f * num_bins, 3), dtype=torch.float32,
                       device=dev)
    hist.index_put_((idx,), vals, accumulate=True)
    return hist.view(num_leaves, f, num_bins, 3)


def sharded_histogram_fn(mesh, num_leaves: int, num_bins: int):
    """The histogram of row-sharded inputs on ``mesh``: a function of the
    global ``(binned, node_of_row, grad, hess)`` (their rows a multiple of
    the ``data`` axis) that computes this rank's block of the rows (the
    shard of ``PartitionSpec("data")``) on the mesh's device and returns
    the sum over the axis, the same on every rank."""
    group = mesh.group(DATA_AXIS)

    def fn(binned, node_of_row, grad, hess):
        start, stop = row_block(int(binned.shape[0]), mesh)
        part = leaf_histograms(
            *(torch.as_tensor(a)[start:stop].to(mesh.device)
              for a in (binned, node_of_row, grad, hess)),
            num_leaves=num_leaves, num_bins=num_bins)
        return collectives.allreduce_sum(part, group)

    return fn
