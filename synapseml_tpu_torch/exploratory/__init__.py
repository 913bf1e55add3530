"""Data-balance analysis (Responsible AI exploratory measures).

Reference: core/src/main/scala/com/microsoft/azure/synapse/ml/exploratory/
(FeatureBalanceMeasure.scala, DistributionBalanceMeasure.scala,
AggregateBalanceMeasure.scala, ~770 LoC; SURVEY.md §2.7).

The port's copy of the JAX package's ``exploratory/__init__.py`` (host code;
the port imports nothing of that package).
"""

from .balance import (AggregateBalanceMeasure, DistributionBalanceMeasure,
                      FeatureBalanceMeasure)

__all__ = ["FeatureBalanceMeasure", "DistributionBalanceMeasure",
           "AggregateBalanceMeasure"]
