"""Causal solvers: OLS with standard errors, simplex-constrained least squares.

The port's counterpart of the JAX package's ``causal/solvers.py``.
Reference: causal/opt/ConstrainedLeastSquare.scala + MirrorDescent.scala —
the synthetic-control weight solve ``min ‖A w − b‖² + λ‖w‖²`` s.t. ``w ≥ 0,
Σw = 1`` done there as a driver-coordinated mirror-descent over distributed
vectors (causal/linalg). ``linear_regression_with_se`` is float64 numpy, a
copy of the JAX package's. The simplex solve is the JAX package's float32
exponentiated-gradient ``while_loop``, run on the caller's device as
``max_iter`` gated steps: a step changes nothing once the loop would have
stopped (``i >= max_iter`` or ``num_iter_no_change`` steps without
improvement), so the result is the ``while_loop``'s best iterate and
intercept, and the host reads the device once, at the end.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device


def linear_regression_with_se(X: np.ndarray, y: np.ndarray,
                              weights: Optional[np.ndarray] = None,
                              fit_intercept: bool = True
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """(coefficients, standard_errors) of OLS/WLS — the final-stage regression
    of every estimator here (reference fitLinearModel,
    BaseDiffInDiffEstimator.scala:49-72). Intercept, if fit, is the last
    coefficient."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    y = np.asarray(y, dtype=np.float64)
    n = X.shape[0]
    if fit_intercept:
        X = np.concatenate([X, np.ones((n, 1))], axis=1)
    w = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
    Xw = X * w[:, None]
    XtX = Xw.T @ X
    beta = np.linalg.solve(XtX + 1e-12 * np.eye(X.shape[1]), Xw.T @ y)
    resid = y - X @ beta
    dof = max(n - X.shape[1], 1)
    sigma2 = float((w * resid ** 2).sum() / dof)
    cov = sigma2 * np.linalg.inv(XtX + 1e-12 * np.eye(X.shape[1]))
    return beta, np.sqrt(np.diag(cov))


def constrained_least_squares(A: np.ndarray, b: np.ndarray,
                              lambda_: float = 0.0,
                              fit_intercept: bool = False,
                              max_iter: int = 200,
                              num_iter_no_change: Optional[int] = None,
                              tol: float = 1e-8,
                              device=DEFAULT_DEVICE) -> Tuple[np.ndarray, float]:
    """``min_w ‖A w − b‖² + λ‖w‖²  s.t. w in simplex`` via exponentiated
    gradient (mirror descent with entropy mirror map), on ``device``.
    Returns (w, intercept). ``lambda_`` is applied as given — callers
    pre-scale (SDID passes zeta² · T_pre, matching the reference's
    fitUnitWeights).

    Reference: causal/opt/ConstrainedLeastSquare.scala (step-size line search +
    numIterNoChange early stop) built on MirrorDescent.scala. The loop keeps
    the best iterate seen and stops after ``num_iter_no_change`` iterations
    without a > ``tol`` improvement (module docstring).
    """
    dev = resolve_device(device)
    A = torch.as_tensor(np.asarray(A, dtype=np.float32), device=dev)
    b = torch.as_tensor(np.asarray(b, dtype=np.float32), device=dev)
    patience = max_iter if num_iter_no_change is None else int(num_iter_no_change)
    w, c = _simplex_solve(A, b, float(lambda_), bool(fit_intercept),
                          int(max_iter), int(patience), float(tol))
    return w.cpu().numpy().astype(np.float64), float(c.cpu())


def _step_sizes(max_iter: int) -> np.ndarray:
    """``eta = 1 / (1 + 0.1 i)`` of each step in float32, as the JAX loop
    computes it from its int32 counter (``1 + 0.1 i`` rounded once: XLA
    contracts it into a fused multiply-add)."""
    i = np.arange(max_iter, dtype=np.float64)
    den = (np.float64(np.float32(0.1)) * i + 1.0).astype(np.float32)
    return (np.float32(1.0) / den).astype(np.float32)


def _simplex_solve(A: torch.Tensor, b: torch.Tensor, lambda_: float,
                   fit_intercept: bool, max_iter: int, patience: int,
                   tol: float):
    """The exponentiated-gradient solve as ``max_iter`` gated steps on
    ``A``'s device: (best w, its intercept) as 0-d/1-d float32 tensors."""
    n = A.shape[1]
    lam = float(np.float32(lambda_))
    tol32 = float(np.float32(tol))
    AT = A.T

    def loss_and_intercept(w):
        r = A @ w - b
        c = r.mean() if fit_intercept else torch.zeros((), device=A.device)
        r = r - c
        return (r * r).sum() + lam * (w * w).sum(), c

    def grad(w):
        r = A @ w - b
        if fit_intercept:
            r = r - r.mean()
        return 2.0 * (AT @ r) + (2.0 * lam) * w

    w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=A.device)
    best_w = w
    best_loss, _ = loss_and_intercept(w)
    stall = torch.zeros((), dtype=torch.int64, device=A.device)
    for eta in _step_sizes(max_iter).tolist():
        live = stall < patience
        logw = torch.log(w.clamp_min(1e-20)) - eta * grad(w)
        logw = logw - logw.max()
        w_new = torch.exp(logw)
        w_new = w_new / w_new.sum()
        loss, _ = loss_and_intercept(w_new)
        improved = loss < best_loss - tol32
        best_w = torch.where(live & improved, w_new, best_w)
        stall = torch.where(live, torch.where(improved, 0, stall + 1), stall)
        best_loss = torch.where(live, torch.minimum(best_loss, loss),
                                best_loss)
        w = torch.where(live, w_new, w)
    _, c = loss_and_intercept(best_w)
    return best_w, c
