"""Causal inference — Double ML, orthogonal forests, diff-in-diff family:
the port's counterpart of the JAX package's ``causal/``.

Reference: core/src/main/scala/com/microsoft/azure/synapse/ml/causal/
(DoubleMLEstimator.scala:63-307, OrthoForestDMLEstimator.scala,
DiffInDiffEstimator.scala, SyntheticControlEstimator.scala,
SyntheticDiffInDiffEstimator.scala, opt/{ConstrainedLeastSquare,
MirrorDescent}.scala, linalg/*; SURVEY.md §2.7). The reference distributes
nuisance fits over Spark and solves the synthetic-control weights with a
driver/executor mirror-descent loop; here nuisance models are the port's
own estimators (on their own device) and the simplex-constrained solve is a
float32 mirror-descent loop on the estimator's ``device``.
"""

from .doubleml import DoubleMLEstimator, DoubleMLModel
from .did import (DiffInDiffEstimator, DiffInDiffModel, DiffInDiffSummary,
                  SyntheticControlEstimator, SyntheticDiffInDiffEstimator)
from .orthoforest import OrthoForestDMLEstimator, OrthoForestDMLModel
from .residual import ResidualTransformer
from .solvers import constrained_least_squares, linear_regression_with_se

__all__ = [
    "DoubleMLEstimator", "DoubleMLModel",
    "DiffInDiffEstimator", "DiffInDiffModel", "DiffInDiffSummary",
    "SyntheticControlEstimator", "SyntheticDiffInDiffEstimator",
    "OrthoForestDMLEstimator", "OrthoForestDMLModel",
    "ResidualTransformer",
    "constrained_least_squares", "linear_regression_with_se",
]
