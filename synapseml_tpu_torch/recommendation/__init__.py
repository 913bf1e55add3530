"""Recommendation — SAR and ranking utilities (the port's counterpart of the
JAX package's ``recommendation/``).

Reference: core/src/main/scala/com/microsoft/azure/synapse/ml/recommendation/
(SAR.scala:36-210, SARModel.scala, RankingAdapter.scala, RankingEvaluator.scala,
RankingTrainValidationSplit.scala, RecommendationIndexer.scala).
The reference assembles the item-item co-occurrence and affinity matrices with
sparse Breeze products inside Spark UDFs; here the co-occurrence and the
scores are dense device products (affinity [U,I] @ similarity [I,I]) with the
same similarity definitions (cooccurrence / jaccard / lift) and time-decayed
affinities.
"""

from .indexer import RecommendationIndexer, RecommendationIndexerModel
from .sar import SAR, SARModel
from .ranking import (RankingAdapter, RankingAdapterModel, RankingEvaluator,
                      RankingTrainValidationSplit)

__all__ = [
    "RecommendationIndexer", "RecommendationIndexerModel",
    "SAR", "SARModel",
    "RankingAdapter", "RankingAdapterModel",
    "RankingEvaluator", "RankingTrainValidationSplit",
]
