"""VowpalWabbit-capability module: hashed-feature online linear learners on
the card (the port's counterpart of the JAX package's ``vw/``).

The reference wraps VowpalWabbit C++ over JNI (hash-trick featurization
JVM-side, online SGD / contextual bandits native, and a spanning-tree
AllReduce for model averaging at pass boundaries,
vw/.../VowpalWabbitBaseLearner.scala:130-188). Here:
  - hashing.py     — VW-style murmur3 feature hashing (host-side, numpy)
  - featurizer.py  — VowpalWabbitFeaturizer / VowpalWabbitInteractions
  - learner.py     — batched sparse SGD engine (gathers and ``index_add_``
                     scatter-adds on the state's device, adagrad adaptive
                     updates), data-parallel over a mesh with
                     pass/segment-boundary weight averaging (the
                     spanning-tree AllReduce analog)
  - estimators.py  — VowpalWabbitClassifier/Regressor/Generic/Progressive/
                     ContextualBandit estimator surface
  - textparse.py   — VW text-line format parser (for the Generic learners)
  - policyeval.py  — off-policy evaluation: IPS / SNIPS / empirical-likelihood
                     CressieRead + intervals, CSE + DSJson transformers
"""

from .hashing import murmur3_32, namespace_hash, hash_feature
from .featurizer import VowpalWabbitFeaturizer, VowpalWabbitInteractions
from .learner import VWConfig, VWState, train_vw, vw_predict
from .estimators import (
    VowpalWabbitClassifier, VowpalWabbitClassificationModel,
    VowpalWabbitRegressor, VowpalWabbitRegressionModel,
    VowpalWabbitGeneric, VowpalWabbitGenericModel,
    VowpalWabbitGenericProgressive,
    VowpalWabbitContextualBandit, VowpalWabbitContextualBanditModel,
)
from .policyeval import (
    KahanSum, ips_estimate, snips_estimate, cressie_read_estimate,
    cressie_read_interval, VowpalWabbitCSETransformer, VowpalWabbitDSJsonTransformer,
)

__all__ = [k for k in dir() if not k.startswith("_")]
