"""Online learning: the serving→training loop, closed and chaos-proofed
(the port's counterpart of the JAX package's ``online/``).

The batch stack trains a policy, ``io/serving`` serves it; this package
closes the loop — served decisions generate propensity-logged feedback
(:mod:`~synapseml_tpu_torch.online.feedback`), a background learner folds that
feedback into the policy continuously (:mod:`~synapseml_tpu_torch.online.loop`),
and a counterfactual gate decides when a learned candidate has earned the
zero-downtime hot-swap (:mod:`~synapseml_tpu_torch.online.promotion`). The same
loop skeleton also carries the anomaly detectors into streaming operation
with adaptive thresholds (:mod:`~synapseml_tpu_torch.online.anomaly`).

Failure model: every stage assumes its input
stream is late, duplicated, or poisoned, every state transition is a
preemption point, and the system-level invariant — accepted prediction
requests are always answered by a promoted, never-regressed policy
version — holds under the full chaos battery.
"""

from .feedback import FeedbackEvent, FeedbackLog, validate_bandit_event
from .loop import OnlineLearnerLoop, StreamLoop
from .policy import (GreedyPolicy, make_policy_handler, policy_builder)
from .promotion import GateDecision, PromotionGate
from .anomaly import (AnomalyEvent, StreamingAnomalyLoop,
                      access_anomaly_stream_scorer, anomaly_feedback_log,
                      iforest_stream_scorer, validate_anomaly_event)

__all__ = [
    "FeedbackEvent", "FeedbackLog", "validate_bandit_event",
    "OnlineLearnerLoop", "StreamLoop",
    "GreedyPolicy", "make_policy_handler", "policy_builder",
    "GateDecision", "PromotionGate",
    "AnomalyEvent", "StreamingAnomalyLoop", "access_anomaly_stream_scorer",
    "anomaly_feedback_log", "iforest_stream_scorer", "validate_anomaly_event",
]
