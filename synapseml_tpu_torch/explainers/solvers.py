"""Weighted least-squares and lasso solvers for local surrogate models.

The port's counterpart of the JAX package's ``explainers/solvers.py``.
Reference: core/.../explainers/{LeastSquaresRegression,LassoRegression,
RegressionBase}.scala — per-row Breeze solves on executors. Here every
row's local regression is solved in one batched call: (R rows) × (S
samples, D features, K targets) → (R, D, K) coefficients.

The batch dimension R is request-sized, so the solves dispatch through
:class:`core.inference.BucketedRunner`: on the card one captured CUDA graph
per ladder bucket, replayed for every later call of that bucket's size.
Runners are cached per static configuration (``("lstsq", ridge)`` /
``("lasso", iters)``) and device; the per-row ``lam`` rides as a
batch-leading input, padded with the other operands.

Nothing in a solve waits on the host, so a whole solve is one graph:

* the least-squares system ``A = Xᵀ W X + ridge · I`` (with the intercept
  column) is symmetric positive definite, so it is solved by Gauss-Jordan
  elimination without pivoting, as tensor operations over its columns
  (the JAX package calls ``jnp.linalg.solve``, LU with partial pivoting;
  the two agree to float32 roundoff on such a system);
* the lasso's FISTA steps are a fixed count of tensor operations; the
  momentum sequence ``t`` does not depend on the data, so its float32
  coefficients are computed once on the host, as XLA computes them.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.inference import BucketedRunner


class FitResult(NamedTuple):
    coefs: np.ndarray        # (R, D, K)
    intercept: np.ndarray    # (R, K)
    r2: np.ndarray           # (R, K)


def _weighted_r2(X, y, w, coefs, intercept):
    """Per row and target, the weighted r² of ``X @ coefs + intercept``;
    ``X`` (R, S, D), ``y`` (R, S, K), ``w`` (R, S)."""
    pred = X @ coefs + intercept[:, None, :]
    wk = w[:, :, None]
    wsum = w.sum(1).clamp_min(1e-12)[:, None]
    ybar = (wk * y).sum(1) / wsum
    ss_res = (wk * (y - pred) ** 2).sum(1)
    ss_tot = (wk * (y - ybar[:, None, :]) ** 2).sum(1).clamp_min(1e-12)
    return 1.0 - ss_res / ss_tot


def _spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A⁻¹ b`` for a batch of symmetric positive definite ``A``
    (R, n, n) and ``b`` (R, n, K): Gauss-Jordan elimination on ``[A | b]``
    column by column, with no pivoting and no host read."""
    n = A.shape[-1]
    M = torch.cat([A, b], dim=-1)
    for j in range(n):
        row = M[:, j, :] / M[:, j, j:j + 1]
        M = M - M[:, :, j:j + 1] * row[:, None, :]
        M[:, j, :] = row
    return M[:, :, n:]


def _lstsq(X, y, w, ridge: float):
    """Weighted least squares with intercept, batched: X (R,S,D), y
    (R,S,K), w (R,S) → (coefs, intercept, r2)."""
    R, S, D = X.shape
    Xa = torch.cat([X, torch.ones((R, S, 1), dtype=X.dtype,
                                  device=X.device)], dim=2)
    Xw = Xa * w[:, :, None]
    XwT = Xw.transpose(1, 2)
    A = XwT @ Xa + ridge * torch.eye(D + 1, dtype=X.dtype, device=X.device)
    sol = _spd_solve(A, XwT @ y)                       # (R, D+1, K)
    coefs, intercept = sol[:, :-1], sol[:, -1]
    return coefs, intercept, _weighted_r2(X, y, w, coefs, intercept)


def _momentum(iters: int) -> np.ndarray:
    """FISTA's ``(t - 1) / t_new`` for each step, in float32 as the JAX
    scan carries ``t``."""
    f32 = np.float32
    t = f32(1.0)
    out = np.empty(iters, f32)
    for i in range(iters):
        t_new = f32(0.5) * (f32(1.0) + np.sqrt(f32(1.0) + f32(4.0) * t * t))
        out[i] = (t - f32(1.0)) / t_new
        t = t_new
    return out


def _lasso(X, y, w, lam, iters: int):
    """Weighted lasso by FISTA on the normal equations, ``iters`` steps,
    batched: X (R,S,D), y (R,S,K), w (R,S), lam (R,)."""
    R, S, D = X.shape
    wk = w[:, :, None]
    wsum = w.sum(1).clamp_min(1e-12)[:, None]
    # center (weighted) so the intercept drops out of the prox step
    xbar = (wk * X).sum(1) / wsum
    ybar = (wk * y).sum(1) / wsum
    sw = torch.sqrt(w)[:, :, None]
    Xc = (X - xbar[:, None, :]) * sw
    yc = (y - ybar[:, None, :]) * sw
    XcT = Xc.transpose(1, 2)
    G = XcT @ Xc
    L = G.diagonal(dim1=1, dim2=2).sum(-1).clamp_min(1e-8)   # trace bound
    eta = (1.0 / L)[:, None, None]
    shrink = (1.0 / L) * lam * S
    shrink = shrink[:, None, None]
    Xty = XcT @ yc
    beta = torch.zeros((R, D, y.shape[2]), dtype=X.dtype, device=X.device)
    z = beta
    for c in _momentum(iters).tolist():
        grad = G @ z - Xty
        b_new = z - eta * grad
        b_new = torch.sign(b_new) * (b_new.abs() - shrink).clamp_min(0.0)
        z = b_new + c * (b_new - beta)
        beta = b_new
    intercept = ybar - (xbar[:, :, None] * beta).sum(1)
    return beta, intercept, _weighted_r2(X, y, w, beta, intercept)


# --- bucketed dispatch -------------------------------------------------------
# one runner per static solver configuration and device; on the card the
# runner captures one graph per R-bucket

_MAX_ROWS_PER_CHUNK = 128
_runner_lock = threading.Lock()
_runners: Dict[Tuple, BucketedRunner] = {}


def _runner(kind: str, static, device) -> BucketedRunner:
    dev = resolve_device(device)
    key = (kind, static, str(dev))
    with _runner_lock:
        runner = _runners.get(key)
        if runner is None:
            if kind == "lstsq":
                def fn(X, y, w, _ridge=static):
                    return _lstsq(X, y, w, _ridge)
            else:
                def fn(X, y, w, lam, _iters=static):
                    return _lasso(X, y, w, lam, _iters)
            runner = BucketedRunner(fn, max_batch_size=_MAX_ROWS_PER_CHUNK,
                                    name=f"explainer_{kind}", device=dev)
            _runners[key] = runner
        return runner


def solver_stats() -> Dict[str, dict]:
    """Per-runner capture/hit counters (steady-state explanations must not
    capture), keyed ``"kind:static"`` and, off the default card,
    ``"kind:static@device"``."""
    with _runner_lock:
        return {(f"{k[0]}:{k[1]}" if k[2] == DEFAULT_DEVICE
                 else f"{k[0]}:{k[1]}@{k[2]}"): r.stats()
                for k, r in _runners.items()}


def batched_lstsq(X, y, w, ridge: float = 1e-6,
                  device=DEFAULT_DEVICE) -> FitResult:
    """Bucketed batched weighted LS on ``device``: X (R,S,D), y (R,S,K),
    w (R,S) → FitResult batched over R (numpy leaves)."""
    return FitResult(*_runner("lstsq", float(ridge), device)(
        np.asarray(X, np.float32), np.asarray(y, np.float32),
        np.asarray(w, np.float32)))


def batched_lasso(X, y, w, lam, iters: int = 200,
                  device=DEFAULT_DEVICE) -> FitResult:
    """Bucketed batched weighted lasso on ``device``; lam scalar or
    (R,)."""
    X = np.asarray(X, np.float32)
    lam_arr = np.array(np.broadcast_to(np.asarray(lam, np.float32),
                                       (X.shape[0],)))
    return FitResult(*_runner("lasso", int(iters), device)(
        X, np.asarray(y, np.float32), np.asarray(w, np.float32), lam_arr))


def solve_batched(X, y, w, regularization: float = 0.0,
                  device=DEFAULT_DEVICE) -> FitResult:
    """Dispatch: lasso when regularization > 0, else (near-)OLS — mirroring
    LIMEBase's regParam semantics. Host-facing: takes numpy, returns numpy
    (dispatched through the bucket ladder on ``device``)."""
    if regularization > 0.0:
        return batched_lasso(X, y, w, regularization, device=device)
    return batched_lstsq(X, y, w, device=device)
