"""Train helpers (SURVEY §2.7 train/, 1291 LoC in reference):
TrainClassifier/TrainRegressor (auto-featurize + fit any estimator) and
ComputeModelStatistics / ComputePerInstanceStatistics metric transformers.

The port's copy of the JAX package's ``train/__init__.py`` (host code; the
port imports nothing of that package).
"""

from .metrics import (MetricConstants, binary_classification_metrics,
                      multiclass_metrics, ranking_ndcg, regression_metrics)
from .stats import ComputeModelStatistics, ComputePerInstanceStatistics
from .train import TrainClassifier, TrainRegressor, TrainedClassifierModel, TrainedRegressorModel

__all__ = ["TrainClassifier", "TrainRegressor", "TrainedClassifierModel",
           "TrainedRegressorModel", "ComputeModelStatistics",
           "ComputePerInstanceStatistics", "MetricConstants",
           "binary_classification_metrics", "regression_metrics",
           "multiclass_metrics", "ranking_ndcg"]
