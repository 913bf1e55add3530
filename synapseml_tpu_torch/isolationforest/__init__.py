"""Isolation forest anomaly detection (the port's counterpart of the JAX
package's ``isolationforest/``).

Reference: core/.../isolationforest/IsolationForest.scala:17-72 — a thin
wrapper over LinkedIn's com.linkedin.isolation-forest estimator. Trees are
grown on the host on small subsamples, exactly as the JAX package grows them
(the same draws in the same order, so the forest arrays are the same bit for
bit), encoded as flat arrays, and scored on the estimator's device as a
fixed-depth gather walk over every (row, tree) pair at once.
"""

from .iforest import IsolationForest, IsolationForestModel

__all__ = ["IsolationForest", "IsolationForestModel"]
