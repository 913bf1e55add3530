"""AccessAnomaly — collaborative-filtering anomaly detection for access logs.

The port's counterpart of the JAX package's ``cyber/access_anomaly.py``.
Reference: cyber/anomaly/collaborative_filtering.py (AccessAnomaly:616-1078,
AccessAnomalyModel:192-537, ModelNormalizeTransformer:1080-1140) and
anomaly/complement_access.py. Semantics kept:

* likelihoods are scaled per tenant to [lowValue, highValue] (default [5, 10]);
* a user×resource matrix factorization is fit per tenant — implicit-feedback
  ALS (confidence ``1 + alpha·r``) by default, or explicit ALS with
  complement-set negatives (``negScore``, ``complementsetFactor``);
* the anomaly score of an observed (user, res) access is the *negative*
  predicted affinity, normalized per tenant to mean 0 / std 1 on the training
  accesses (higher ⇒ more anomalous); unseen users/resources score 0.

Each tenant's ALS runs on the estimator's device as batched tensors: one
side's normal equations for every row at once, ``A = reshape(C @ (X ⊗ X)) +
λI`` (a ``[n, m] × [m, rank²]`` product) and ``b = (C ⊙ P) @ X``, then one
batched solve, ``maxIter`` times with no host read inside the loop. The
initial factors and the explicit mode's complement draw are host numpy in
the JAX package's order, so both packages start from the same factors; the
per-tenant normalization, ``transform`` and the complement sampler are host
numpy, as there.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.params import Param, Params
from ..core.pipeline import Estimator, Model, Transformer
from ..core.table import Table


class AccessAnomalyConfig:
    """Defaults (reference AccessAnomalyConfig:61-86)."""
    default_tenant_col = "tenant"
    default_user_col = "user"
    default_res_col = "res"
    default_likelihood_col = "likelihood"
    default_output_col = "anomaly_score"


class _AccessAnomalyParams(Params):
    tenantCol = Param("tenantCol", "tenant column partitioning independent "
                      "groups", str, AccessAnomalyConfig.default_tenant_col)
    userCol = Param("userCol", "user column", str,
                    AccessAnomalyConfig.default_user_col)
    resCol = Param("resCol", "resource column", str,
                   AccessAnomalyConfig.default_res_col)
    likelihoodCol = Param("likelihoodCol", "likelihood of the access (e.g. "
                          "counts per time unit)", str,
                          AccessAnomalyConfig.default_likelihood_col)
    outputCol = Param("outputCol", "anomaly score column (mean 0, std 1)", str,
                      AccessAnomalyConfig.default_output_col)
    rankParam = Param("rankParam", "number of latent factors", int, 10)
    maxIter = Param("maxIter", "ALS iterations", int, 25)
    regParam = Param("regParam", "ALS regularization", float, 0.1)
    lowValue = Param("lowValue", "likelihood scaled-range low", float, 5.0)
    highValue = Param("highValue", "likelihood scaled-range high", float, 10.0)
    applyImplicitCf = Param("applyImplicitCf", "implicit-feedback ALS", bool,
                            True)
    alphaParam = Param("alphaParam", "implicit confidence scale", float, 1.0)
    complementsetFactor = Param("complementsetFactor",
                                "negatives per positive (explicit mode)", int, 2)
    negScore = Param("negScore", "score assigned to complement-set pairs "
                     "(explicit mode)", float, 1.0)
    separateTenants = Param("separateTenants", "kept for API parity; tenants "
                            "are always isolated here", bool, False)
    seed = Param("seed", "random seed", int, 0)
    device = Param("device", "Device that fits the factorizations: 'cuda' "
                   "(default) or 'cpu'", str, DEFAULT_DEVICE)


class AccessAnomaly(Estimator, _AccessAnomalyParams):
    def _fit(self, df: Table) -> "AccessAnomalyModel":
        tenants = df[self.getTenantCol()]
        models: Dict[Any, dict] = {}
        for t in np.unique(tenants):
            key = t.item() if isinstance(t, np.generic) else t
            models[key] = self._fit_tenant(df.take(np.flatnonzero(tenants == t)))
        return AccessAnomalyModel(
            tenantModels=models, **{p: self.get(p) for p in self._paramMap})

    def _fit_tenant(self, df: Table) -> dict:
        dev = resolve_device(self.getDevice())
        users, u_ix = np.unique(df[self.getUserCol()], return_inverse=True)
        ress, r_ix = np.unique(df[self.getResCol()], return_inverse=True)
        lik = (np.asarray(df[self.getLikelihoodCol()], np.float64)
               if self.getLikelihoodCol() in df else np.ones(df.num_rows))
        # scale likelihood to [lowValue, highValue] (reference :616 lowValue doc)
        lo, hi = self.getLowValue(), self.getHighValue()
        if lik.max() > lik.min():
            lik = lo + (hi - lo) * (lik - lik.min()) / (lik.max() - lik.min())
        else:
            lik = np.full_like(lik, lo)
        n_u, n_r = len(users), len(ress)
        R = np.zeros((n_u, n_r), dtype=np.float32)
        R[u_ix, r_ix] = lik

        if self.getApplyImplicitCf():
            U, V = _als_implicit(R, self.getRankParam(), self.getMaxIter(),
                                 self.getRegParam(), self.getAlphaParam(),
                                 self.getSeed(), dev)
        else:
            U, V = _als_explicit(R, self.getRankParam(), self.getMaxIter(),
                                 self.getRegParam(), self.getNegScore(),
                                 self.getComplementsetFactor(), self.getSeed(),
                                 dev)

        # per-tenant normalization of observed-access scores to mean 0 / std 1
        # (reference ModelNormalizeTransformer:1080-1140); score = -affinity
        raw = -np.einsum("ij,ij->i", U[u_ix], V[r_ix])
        mean, std = float(raw.mean()), float(raw.std()) or 1.0
        return {"users": {u.item() if isinstance(u, np.generic) else u: i
                          for i, u in enumerate(users)},
                "resources": {r.item() if isinstance(r, np.generic) else r: i
                              for i, r in enumerate(ress)},
                "U": U, "V": V, "mean": mean, "std": std}


class AccessAnomalyModel(Model, _AccessAnomalyParams):
    tenantModels = Param("tenantModels",
                         "tenant -> {users, resources, U, V, mean, std}",
                         is_complex=True)

    def _transform(self, df: Table) -> Table:
        models = self.get("tenantModels")
        tenants = df[self.getTenantCol()]
        users = df[self.getUserCol()]
        ress = df[self.getResCol()]
        out = np.zeros(df.num_rows, dtype=np.float64)
        for t in np.unique(tenants):
            key = t.item() if isinstance(t, np.generic) else t
            m = models.get(key)
            if m is None:
                continue
            rows = np.flatnonzero(tenants == t)
            # vectorized per tenant: map to indices once, one batched einsum
            ui = np.asarray([m["users"].get(
                u.item() if isinstance(u, np.generic) else u, -1)
                for u in users[rows]])
            ri = np.asarray([m["resources"].get(
                r.item() if isinstance(r, np.generic) else r, -1)
                for r in ress[rows]])
            valid = (ui >= 0) & (ri >= 0)  # unseen user/resource scores 0
            if not valid.any():
                continue
            raw = -np.einsum("ij,ij->i", m["U"][ui[valid]], m["V"][ri[valid]])
            out[rows[valid]] = (raw - m["mean"]) / m["std"]
        return df.with_column(self.getOutputCol(), out)


class ComplementAccessTransformer(Transformer):
    """Emit (tenant, user, res) pairs NOT present in the input — a sample of
    the complement set (reference anomaly/complement_access.py:13-130)."""

    tenantCol = Param("tenantCol", "tenant column", str,
                      AccessAnomalyConfig.default_tenant_col)
    indexedColNamesArr = Param("indexedColNamesArr", "indexed columns", list)
    complementsetFactor = Param("complementsetFactor",
                                "complement samples per observed row", int, 2)
    seed = Param("seed", "random seed", int, 0)

    def _transform(self, df: Table) -> Table:
        cols = self.get("indexedColNamesArr") or ["user", "res"]
        u_col, r_col = cols[0], cols[1]
        tenants = df[self.getTenantCol()]
        rng = np.random.default_rng(self.getSeed())
        out = {self.getTenantCol(): [], u_col: [], r_col: []}
        for t in np.unique(tenants):
            sel = tenants == t
            us = np.unique(df[u_col][sel])
            rs = np.unique(df[r_col][sel])
            seen = set(zip(df[u_col][sel].tolist(), df[r_col][sel].tolist()))
            want = self.getComplementsetFactor() * int(sel.sum())
            budget = len(us) * len(rs) - len(seen)
            want = min(want, max(budget, 0))
            tries = 0
            emitted = set()
            while len(emitted) < want and tries < 50 * max(want, 1):
                pair = (us[rng.integers(len(us))], rs[rng.integers(len(rs))])
                tries += 1
                if pair in seen or pair in emitted:
                    continue
                emitted.add(pair)
            for u, r in emitted:
                out[self.getTenantCol()].append(t)
                out[u_col].append(u)
                out[r_col].append(r)
        return Table({k: np.asarray(v) for k, v in out.items()})


# --------------------------------------------------------------------------
# ALS solvers (dense batched normal equations on the device)

def _solve_side(X: torch.Tensor, Cm: torch.Tensor, CPm: torch.Tensor,
                eye: torch.Tensor) -> torch.Tensor:
    """For each row i of ``Cm``: ``(Xᵀ Cᵢ X + λI) w = Xᵀ (Cᵢ ⊙ Pᵢ)``, all
    rows in one product and one batched solve (``CPm`` is ``Cm ⊙ Pm``)."""
    m, rank = X.shape
    XX = (X[:, :, None] * X[:, None, :]).reshape(m, rank * rank)
    A = (Cm @ XX).reshape(Cm.shape[0], rank, rank) + eye
    w, _ = torch.linalg.solve_ex(A, CPm @ X, check_errors=False)
    return w


def _alternate(C: torch.Tensor, CP: torch.Tensor, U: torch.Tensor,
               V: torch.Tensor, iters: int, reg: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``iters`` alternating solves (users, then resources) on the device;
    the factors come back to the host once, at the end."""
    rank = U.shape[1]
    eye = reg * torch.eye(rank, dtype=torch.float32, device=U.device)
    Ct, CPt = C.T.contiguous(), CP.T.contiguous()
    with torch.no_grad():
        for _ in range(iters):
            U = _solve_side(V, C, CP, eye)
            V = _solve_side(U, Ct, CPt, eye)
    return U.cpu().numpy(), V.cpu().numpy()


def _als_implicit(R: np.ndarray, rank: int, iters: int, reg: float,
                  alpha: float, seed: int, device=DEFAULT_DEVICE
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Implicit-feedback ALS (Hu/Koren/Volinsky): confidence C = 1 + alpha·R,
    preference P = [R > 0]."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_u, n_r = R.shape
    U0 = rng.normal(scale=0.1, size=(n_u, rank)).astype(np.float32)
    V0 = rng.normal(scale=0.1, size=(n_r, rank)).astype(np.float32)
    Rt = torch.as_tensor(R, dtype=torch.float32, device=dev)
    C = 1.0 + alpha * Rt
    CP = C * (Rt > 0).to(torch.float32)
    return _alternate(C, CP, torch.as_tensor(U0, device=dev),
                      torch.as_tensor(V0, device=dev), iters, reg)


def _als_explicit(R: np.ndarray, rank: int, iters: int, reg: float,
                  neg_score: float, complement_factor: int, seed: int,
                  device=DEFAULT_DEVICE) -> Tuple[np.ndarray, np.ndarray]:
    """Explicit ALS over observed entries plus complement-set negatives set to
    ``neg_score`` (reference applyImplicitCf=False branch)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_u, n_r = R.shape
    obs = R > 0
    # sample complement entries into a weight mask
    W = obs.astype(np.float32).copy()
    Rfull = R.astype(np.float32).copy()
    n_neg = min(complement_factor * int(obs.sum()), obs.size - int(obs.sum()))
    if n_neg > 0:
        flat_closed = np.flatnonzero(~obs.ravel())
        chosen = rng.choice(flat_closed, size=n_neg, replace=False)
        W.ravel()[chosen] = 1.0
        Rfull.ravel()[chosen] = neg_score
    U0 = rng.normal(scale=0.1, size=(n_u, rank)).astype(np.float32)
    V0 = rng.normal(scale=0.1, size=(n_r, rank)).astype(np.float32)
    Wt = torch.as_tensor(W, device=dev)
    return _alternate(Wt, Wt * torch.as_tensor(Rfull, device=dev),
                      torch.as_tensor(U0, device=dev),
                      torch.as_tensor(V0, device=dev), iters, reg)
