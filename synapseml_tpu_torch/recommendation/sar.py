"""SAR — Smart Adaptive Recommendations.

Reference: recommendation/SAR.scala:36-210 and SARModel.scala. Semantics kept:

* **Item-item similarity** from the user-item interaction matrix ``A`` (binary
  occurrence, items below ``supportThreshold`` dropped): co-occurrence
  ``C = Aᵀ A``; ``jaccard(i,j) = c_ij / (c_ii + c_jj − c_ij)``;
  ``lift(i,j) = c_ij / (c_ii · c_jj)`` (SAR.scala:184-196).
* **User affinity** with exponential time decay: each (user, item, rating, t)
  contributes ``rating · 2^(−(t_ref − t) / T_half)`` where ``T_half`` is
  ``timeDecayCoeff`` days (SAR.scala:87-96); without a time column the rating
  itself is the affinity.
* **Scoring**: recommendations rank ``affinity @ similarity`` — dense
  [users, I]×[I, I] products on the device here, versus per-row sparse Breeze
  products in UDFs there.

The port's counterpart of the JAX package's ``recommendation/sar.py``. The
occurrence matrix and the time-decayed affinity are built on the host in
numpy, as there (bitwise the same). The co-occurrence ``Oᵀ O`` runs on the
model's device: on 0/1 float32 every count is an integer below 2²⁴, so the
product is exact in any summation order while TF32 stays off
(``core/device.py``), and jaccard and lift are single IEEE divisions, so
``itemSimilarity`` is the JAX package's bit for bit. Scoring goes through
the port's ``BucketedRunner`` (one captured CUDA graph per bucket of up to
256 users on the card, the similarity held on the device), and the top k is
taken there too (``ops.topk.top_k``: ``jax.lax.top_k``'s order, ties to the
lower item index), so only ``[users, k]`` comes back to the host.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Optional

import numpy as np

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.inference import BucketedRunner
from ..core.params import Param, Params
from ..core.pipeline import Estimator, Model
from ..core.table import Table
from ..ops.topk import top_k

_SIMS = ("cooccurrence", "jaccard", "lift")

_MAX_USERS_PER_CHUNK = 256
# users scored per runner call in ``transform``: a multiple of the runner's
# chunk, so every chunk is the one the whole call would make, and the host
# holds at most this many rows of scores
_TRANSFORM_USERS = 32 * _MAX_USERS_PER_CHUNK


class _SARParams(Params):
    userCol = Param("userCol", "Column of user indices (0..numUsers-1)", str, "user")
    itemCol = Param("itemCol", "Column of item indices (0..numItems-1)", str, "item")
    ratingCol = Param("ratingCol", "Column of ratings", str, "rating")
    timeCol = Param("timeCol", "Time of activity", str, "time")
    similarityFunction = Param(
        "similarityFunction",
        "Defines the similarity function to be used by the model: "
        "lift, jaccard, cooccurrence", str, "jaccard",
        validator=lambda v: v if v in _SIMS else (_ for _ in ()).throw(
            ValueError(f"similarityFunction must be one of {_SIMS}, got {v!r}")))
    supportThreshold = Param("supportThreshold",
                             "Minimum number of ratings per item", int, 4)
    timeDecayCoeff = Param("timeDecayCoeff",
                           "Half-life of the time decay, in days", int, 30)
    startTime = Param("startTime",
                      "Custom 'now' reference time for historical data", str)
    startTimeFormat = Param("startTimeFormat", "Format for startTime", str,
                            "%Y-%m-%d %H:%M:%S")
    activityTimeFormat = Param("activityTimeFormat",
                               "Format for the time column when it is strings",
                               str, "%Y-%m-%d %H:%M:%S")
    device = Param("device", "Device that computes the similarity and the "
                   "scores: 'cuda' (default) or 'cpu'", str, DEFAULT_DEVICE)


class SAR(Estimator, _SARParams):
    """Fit the affinity and similarity matrices (reference SAR.scala)."""

    def _fit(self, df: Table) -> "SARModel":
        dev = resolve_device(self.getDevice())
        users = np.asarray(df[self.getUserCol()], dtype=np.int64)
        items = np.asarray(df[self.getItemCol()], dtype=np.int64)
        n_users = int(users.max()) + 1 if users.size else 0
        n_items = int(items.max()) + 1 if items.size else 0
        ratings = (np.asarray(df[self.getRatingCol()], dtype=np.float32)
                   if self.getRatingCol() in df else np.ones(len(users), np.float32))

        # --- occurrence matrix + support filter ------------------------
        occ = np.zeros((n_users, n_items), dtype=np.float32)
        occ[users, items] = 1.0
        support = occ.sum(axis=0)
        active = support >= self.getSupportThreshold()
        occ[:, ~active] = 0.0

        sim = _similarity(occ, self.getSimilarityFunction(), dev)

        # --- time-decayed affinity -------------------------------------
        decay = np.ones(len(users), dtype=np.float32)
        if self.getTimeCol() in df:
            t = _to_epoch_minutes(df[self.getTimeCol()], self.getActivityTimeFormat())
            if self.isSet("startTime"):
                ref = datetime.strptime(
                    self.getStartTime(), self.getStartTimeFormat()
                ).replace(tzinfo=timezone.utc).timestamp() / 60.0
            else:
                ref = t.max()
            half_life_min = float(self.getTimeDecayCoeff()) * 24 * 60
            decay = np.exp2(-(ref - t) / half_life_min).astype(np.float32)
        affinity = np.zeros((n_users, n_items), dtype=np.float32)
        np.add.at(affinity, (users, items), ratings * decay)

        return SARModel(itemSimilarity=sim, userAffinity=affinity,
                        **{p: self.get(p) for p in self._paramMap})


class SARModel(Model, _SARParams):
    itemSimilarity = Param("itemSimilarity", "[I, I] item-item similarity",
                           is_complex=True)
    userAffinity = Param("userAffinity", "[U, I] time-decayed user affinity",
                         is_complex=True)

    def getItemDataFrame(self) -> Table:
        sim = self.get("itemSimilarity")
        return Table({self.getItemCol(): np.arange(sim.shape[0]),
                      "jaccardList": sim})

    def getUserDataFrame(self) -> Table:
        aff = self.get("userAffinity")
        return Table({self.getUserCol(): np.arange(aff.shape[0]),
                      "flatList": aff})

    def _score_runner(self, k: Optional[int] = None) -> BucketedRunner:
        """Per-model cached :class:`BucketedRunner` over user rows: the
        similarity matrix rides as a device constant, the request-sized user
        dimension pads to the bucket ladder so scoring captures once per
        bucket, not once per distinct query size. ``k`` None returns the
        scores; an int, their top ``k`` (values, item indices)."""
        sim_np = self.get("itemSimilarity")
        dev = resolve_device(self.getDevice())
        cached = getattr(self, "_runner_cache", None)
        if cached is None or cached[0] is not sim_np or cached[1] != dev:
            sim = torch.as_tensor(np.require(sim_np, np.float32, "W"),
                                  device=dev)
            cached = (sim_np, dev, sim, {})
            self._runner_cache = cached
        sim, runners = cached[2], cached[3]
        runner = runners.get(k)
        if runner is None:
            if k is None:
                def fn(aff):
                    return aff @ sim
            else:
                def fn(aff):
                    return top_k(aff @ sim, k)
            runner = BucketedRunner(fn, max_batch_size=_MAX_USERS_PER_CHUNK,
                                    name="sar_scores" if k is None
                                    else f"sar_top{k}", device=dev)
            runners[k] = runner
        return runner

    def _affinity(self, users: Optional[np.ndarray] = None) -> np.ndarray:
        aff = self.get("userAffinity")
        if users is not None:
            aff = aff[users]
        return np.asarray(aff, dtype=np.float32)

    def _scores(self, users: Optional[np.ndarray] = None) -> np.ndarray:
        """affinity[users] @ similarity — only the requested user rows are
        multiplied (the full [U,I]·[I,I] product is never materialized for
        subset queries)."""
        aff = self._affinity(users)
        if aff.shape[0] == 0:
            return np.zeros((0, self.get("itemSimilarity").shape[0]), np.float32)
        return self._score_runner()(aff)

    def _top_k(self, users: Optional[np.ndarray], num_items: int):
        """(item indices int32, scores) of the top ``num_items`` of the
        requested users, taken on the device."""
        aff = self._affinity(users)
        k = min(num_items, aff.shape[1])
        if aff.shape[0] == 0 or k == 0:
            return np.zeros((aff.shape[0], k), np.int32), \
                np.zeros((aff.shape[0], k), np.float32)
        vals, idx = self._score_runner(k)(aff)
        return idx.astype(np.int32), vals

    def _transform(self, df: Table) -> Table:
        """Score (user, item) pairs — predicted rating column."""
        u = np.asarray(df[self.getUserCol()], dtype=np.int64)
        i = np.asarray(df[self.getItemCol()], dtype=np.int64)
        uniq, inv = np.unique(u, return_inverse=True)
        pred = np.zeros(len(u), np.float32)
        order = np.argsort(inv, kind="stable")
        bounds = np.searchsorted(inv[order], np.arange(
            0, len(uniq) + _TRANSFORM_USERS, _TRANSFORM_USERS))
        for c, start in enumerate(range(0, len(uniq), _TRANSFORM_USERS)):
            scores = self._scores(uniq[start:start + _TRANSFORM_USERS])
            rows = order[bounds[c]:bounds[c + 1]]
            pred[rows] = scores[inv[rows] - start, i[rows]]
        return df.with_column("prediction", pred)

    def recommend_for_all_users(self, num_items: int) -> Table:
        """Top ``num_items`` per user (SARModel.scala:48-56): columns user,
        recommendations=[item indices], ratings=[scores]."""
        idx, vals = self._top_k(None, num_items)
        return Table({
            self.getUserCol(): np.arange(idx.shape[0]),
            "recommendations": idx,
            "ratings": vals,
        })

    def recommend_for_user_subset(self, df: Table, num_items: int) -> Table:
        users = np.unique(np.asarray(df[self.getUserCol()], dtype=np.int64))
        idx, vals = self._top_k(users, num_items)
        return Table({
            self.getUserCol(): users,
            "recommendations": idx,
            "ratings": vals,
        })

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_runner_cache", None)   # device tensors and graphs
        return state

    recommendForAllUsers = recommend_for_all_users
    recommendForUserSubset = recommend_for_user_subset


def _similarity(occ: np.ndarray, kind: str, device=DEFAULT_DEVICE
                ) -> np.ndarray:
    """The [I, I] item similarity of a 0/1 occurrence matrix, computed on
    ``device`` and returned as float32 numpy."""
    dev = resolve_device(device)
    with torch.no_grad():
        o = torch.as_tensor(occ, device=dev)
        c = o.T @ o  # co-occurrence [I, I]; exact: integer counts < 2^24
        del o
        diag = torch.diagonal(c)
        if kind == "jaccard":
            denom = diag[:, None] + diag[None, :] - c
            c = torch.where(denom > 0, c / denom, 0.0)
        elif kind == "lift":
            denom = diag[:, None] * diag[None, :]
            c = torch.where(denom > 0, c / denom, 0.0)
        return c.cpu().numpy()


def _to_epoch_minutes(col: np.ndarray, fmt: str) -> np.ndarray:
    if np.issubdtype(col.dtype, np.datetime64):
        return col.astype("datetime64[s]").astype(np.float64) / 60.0
    if col.dtype == object or col.dtype.kind in "US":
        return np.asarray([
            datetime.strptime(str(v), fmt).replace(tzinfo=timezone.utc).timestamp()
            for v in col], dtype=np.float64) / 60.0
    return np.asarray(col, dtype=np.float64) / 60.0  # numeric epoch seconds
