"""Nearest neighbors — maximum-inner-product search on the card (the port's
counterpart of the JAX package's ``nn/``).

Reference: core/src/main/scala/com/microsoft/azure/synapse/ml/nn/
(BallTree.scala, KNN.scala:49-127, ConditionalKNN.scala; SURVEY.md §2.7).
The reference answers max-inner-product queries with a serial ball-tree
pointer chase per row (built once, broadcast, a UDF per query). Here queries
are batched: all queries × all keys as one product on the device with a
top-k in ``jax.lax.top_k``'s order, with an optional two-level ball index
that prunes key blocks by an inner-product upper bound for large corpora.
"""

from .balltree import BallTree, ConditionalBallTree
from .knn import KNN, KNNModel, ConditionalKNN, ConditionalKNNModel

__all__ = [
    "BallTree",
    "ConditionalBallTree",
    "KNN",
    "KNNModel",
    "ConditionalKNN",
    "ConditionalKNNModel",
]
