"""CyberML — access-anomaly detection and cyber feature engineering (the
port's counterpart of the JAX package's ``cyber/``).

Reference: core/src/main/python/synapse/ml/cyber/ (~2.5k LoC pure PySpark):
anomaly/collaborative_filtering.py (AccessAnomaly — ALS over user×resource
access likelihoods, standardized anomaly scores),
anomaly/complement_access.py, feature/indexers.py, feature/scalers.py.
The reference runs Spark ALS per tenant; here each tenant's factorization is
a dense alternating-ridge solve on the device (batched normal equations and
one batched linear solve per side and iteration).
"""

from .access_anomaly import (AccessAnomaly, AccessAnomalyConfig,
                             AccessAnomalyModel, ComplementAccessTransformer)
from .indexers import IdIndexer, IdIndexerModel, MultiIndexer, MultiIndexerModel
from .scalers import (LinearScalarScaler, LinearScalarScalerModel,
                      StandardScalarScaler, StandardScalarScalerModel)

__all__ = [
    "AccessAnomaly", "AccessAnomalyConfig", "AccessAnomalyModel",
    "ComplementAccessTransformer",
    "IdIndexer", "IdIndexerModel", "MultiIndexer", "MultiIndexerModel",
    "StandardScalarScaler", "StandardScalarScalerModel",
    "LinearScalarScaler", "LinearScalarScalerModel",
]
