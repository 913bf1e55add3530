"""Difference-in-differences family.

Reference: causal/DiffInDiffEstimator.scala, SyntheticControlEstimator.scala,
SyntheticDiffInDiffEstimator.scala over BaseDiffInDiffEstimator.scala +
SyntheticEstimator.scala. All three reduce to a (weighted) linear regression
whose interaction coefficient is the treatment effect
(BaseDiffInDiffEstimator.scala:49-72, DiffInDiffSummary:74); the synthetic
variants first solve simplex-constrained least squares for unit (and time)
weights — here via the mirror-descent solver in solvers.py, on the
estimator's ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core.device import DEFAULT_DEVICE
from ..core.params import Param, Params
from ..core.pipeline import Estimator, Model
from ..core.table import Table
from .solvers import constrained_least_squares, linear_regression_with_se


@dataclass
class DiffInDiffSummary:
    """Reference: BaseDiffInDiffEstimator.scala:74-80."""
    treatmentEffect: float
    standardError: float
    timeIntercept: Optional[float] = None
    unitIntercept: Optional[float] = None
    timeWeights: Optional[np.ndarray] = None
    unitWeights: Optional[np.ndarray] = None
    zeta: float = 0.0
    lossHistory: List[float] = field(default_factory=list)


class _DiDParams(Params):
    treatmentCol = Param("treatmentCol", "1 for treated units", str, "treatment")
    postTreatmentCol = Param("postTreatmentCol", "1 for post-treatment periods",
                             str, "postTreatment")
    outcomeCol = Param("outcomeCol", "outcome column", str, "outcome")
    unitCol = Param("unitCol", "unit (panel id) column", str, "unit")
    timeCol = Param("timeCol", "time period column", str, "time")


class DiffInDiffModel(Model, _DiDParams):
    summary = Param("summary", "DiffInDiffSummary", is_complex=True)

    def getSummary(self) -> DiffInDiffSummary:
        s = self.get("summary")
        if s is None:
            raise ValueError("No summary available for this DiffInDiffModel")
        return s

    def _transform(self, df: Table) -> Table:
        return df.with_column("EffectAverage",
                              np.full(df.num_rows,
                                      self.getSummary().treatmentEffect))


class DiffInDiffEstimator(Estimator, _DiDParams):
    """Classic 2×2 DiD: regress outcome on treatment, post, and their
    interaction; the interaction coefficient is the effect
    (reference DiffInDiffEstimator.scala)."""

    def _fit(self, df: Table) -> DiffInDiffModel:
        t = np.asarray(df[self.getTreatmentCol()], np.float64)
        post = np.asarray(df[self.getPostTreatmentCol()], np.float64)
        y = np.asarray(df[self.getOutcomeCol()], np.float64)
        X = np.stack([t * post, t, post], axis=1)
        beta, se = linear_regression_with_se(X, y)
        return DiffInDiffModel(
            summary=DiffInDiffSummary(float(beta[0]), float(se[0])),
            **{p: self.get(p) for p in self._paramMap})


def _did_params(stage) -> dict:
    """Set params that DiffInDiffModel itself declares (solver params stay on
    the estimator)."""
    return {p: stage.get(p) for p in stage._paramMap
            if p in DiffInDiffModel._params}


class _SyntheticParams(_DiDParams):
    lambda_ = Param("lambda_", "L2 regularization for the weight solve, "
                    "applied as given (un-scaled) like the reference's "
                    "fitUnitWeights; SDID's rule-of-thumb passes zeta^2*T_pre",
                    float, 0.0)
    maxIter = Param("maxIter", "mirror-descent iterations", int, 200)
    numIterNoChange = Param("numIterNoChange", "early-stop patience", int, 25)
    epsilon = Param("epsilon", "solver tolerance", float, 1e-8)
    zetaRatio = Param("zetaRatio", "sdid time-regularization ratio "
                      "(None -> rule-of-thumb)", float)
    device = Param("device", "Device of the weight solves: 'cuda' "
                   "(default) or 'cpu'", str, DEFAULT_DEVICE)


def _panel(df: Table, p: _SyntheticParams):
    """Pivot long panel data into Y[unit, time] + treated/post indicators."""
    units, u_ix = np.unique(df[p.getUnitCol()], return_inverse=True)
    times, t_ix = np.unique(df[p.getTimeCol()], return_inverse=True)
    Y = np.full((len(units), len(times)), np.nan)
    Y[u_ix, t_ix] = np.asarray(df[p.getOutcomeCol()], np.float64)
    if np.isnan(Y).any():
        missing = int(np.isnan(Y).sum())
        raise ValueError(
            f"unbalanced panel: {missing} (unit, time) cells have no outcome "
            "row; synthetic estimators need every unit observed every period")
    treated = np.zeros(len(units), bool)
    treated[u_ix[np.asarray(df[p.getTreatmentCol()], np.float64) > 0]] = True
    post = np.zeros(len(times), bool)
    post[t_ix[np.asarray(df[p.getPostTreatmentCol()], np.float64) > 0]] = True
    if not treated.any() or treated.all():
        raise ValueError("need both treated and control units")
    if not post.any() or post.all():
        raise ValueError("need both pre and post periods")
    return Y, treated, post


class SyntheticControlEstimator(Estimator, _SyntheticParams):
    """Synthetic control: unit weights on controls matching the treated
    pre-period trajectory, then a weighted 2×2 DiD regression
    (reference SyntheticControlEstimator.scala)."""

    def _fit(self, df: Table) -> DiffInDiffModel:
        Y, treated, post = _panel(df, self)
        pre = ~post
        A = Y[~treated][:, pre].T                # [preT, nControls]
        b = Y[treated][:, pre].mean(axis=0)      # mean treated pre trajectory
        w, _ = constrained_least_squares(
            A, b, self.get("lambda_") or 0.0, max_iter=self.getMaxIter(),
            num_iter_no_change=self.getNumIterNoChange(),
            tol=self.getEpsilon(), device=self.getDevice())
        unit_w = np.zeros(Y.shape[0])
        unit_w[~treated] = w
        unit_w[treated] = 1.0 / treated.sum()
        eff, se = _weighted_did(Y, treated, post, unit_w,
                                np.full(Y.shape[1], 1.0 / Y.shape[1]))
        return DiffInDiffModel(
            summary=DiffInDiffSummary(eff, se, unitWeights=unit_w),
            **_did_params(self))


class SyntheticDiffInDiffEstimator(Estimator, _SyntheticParams):
    """Synthetic DiD (Arkhangelsky et al.): simplex unit weights matching
    pre-period control→treated levels AND simplex time weights matching
    pre→post control levels, then the weighted DiD regression
    (reference SyntheticDiffInDiffEstimator.scala)."""

    def _fit(self, df: Table) -> DiffInDiffModel:
        Y, treated, post = _panel(df, self)
        pre = ~post
        ctrl = Y[~treated]
        # unit weights: control pre trajectories -> treated pre mean
        A_u = ctrl[:, pre].T
        b_u = Y[treated][:, pre].mean(axis=0)
        zeta = self._zeta(Y, post, treated)
        # regularization = zeta^2 * T_pre, passed unscaled to the solver
        # (SyntheticEstimator.scala:111-115 fitUnitWeights)
        w_u, _ = constrained_least_squares(
            A_u, b_u, zeta ** 2 * float(pre.sum()), fit_intercept=True,
            max_iter=self.getMaxIter(),
            num_iter_no_change=self.getNumIterNoChange(),
            tol=self.getEpsilon(), device=self.getDevice())
        # time weights: control pre periods -> control post mean
        A_t = ctrl[:, pre]
        b_t = ctrl[:, post].mean(axis=1)
        w_t, _ = constrained_least_squares(
            A_t, b_t, fit_intercept=True, max_iter=self.getMaxIter(),
            num_iter_no_change=self.getNumIterNoChange(),
            tol=self.getEpsilon(), device=self.getDevice())
        unit_w = np.zeros(Y.shape[0])
        unit_w[~treated] = w_u
        unit_w[treated] = 1.0 / treated.sum()
        time_w = np.zeros(Y.shape[1])
        time_w[pre] = w_t
        time_w[post] = 1.0 / post.sum()
        eff, se = _weighted_did(Y, treated, post, unit_w, time_w)
        return DiffInDiffModel(
            summary=DiffInDiffSummary(eff, se, unitWeights=unit_w,
                                      timeWeights=time_w, zeta=zeta),
            **_did_params(self))

    def _zeta(self, Y: np.ndarray, post: np.ndarray,
              treated: np.ndarray) -> float:
        if self.isSet("zetaRatio"):
            return float(self.getZetaRatio())
        # Arkhangelsky et al. rule of thumb: (N_treated · T_post)^(1/4) times
        # the sd of first differences of CONTROL units' pre-period outcomes
        diffs = np.diff(Y[~treated][:, ~post], axis=1)
        n_tr_post = float(treated.sum() * post.sum())
        # sample std (ddof=1) to match the reference's stddev_samp
        return float(n_tr_post ** 0.25 * diffs.std(ddof=1))


def _weighted_did(Y, treated, post, unit_w, time_w):
    """Weighted interaction regression over the unit×time panel."""
    U, T = Y.shape
    t_ind = np.repeat(treated.astype(np.float64), T)
    p_ind = np.tile(post.astype(np.float64), U)
    y = Y.ravel()
    # epsilon added to every weight so all panel cells stay in the regression
    # (reference SyntheticDiffInDiffEstimator keeps all rows via coalesce + eps,
    # which matches its degrees of freedom / standard errors)
    w = np.repeat(unit_w, T) * np.tile(time_w, U) + 1e-10
    X = np.stack([t_ind * p_ind, t_ind, p_ind], axis=1)
    beta, se = linear_regression_with_se(X, y, weights=w)
    return float(beta[0]), float(se[0])
