from .device import resolve_device  # noqa: F401
from .params import (  # noqa: F401
    Param,
    Params,
    HasFeaturesCol,
    HasLabelCol,
    HasInputCol,
    HasInputCols,
    HasOutputCol,
    HasOutputCols,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasWeightCol,
    HasValidationIndicatorCol,
    HasInitScoreCol,
    HasGroupCol,
    HasSeed,
)
from .table import Table, assemble_features, feature_matrix  # noqa: F401
from .pipeline import (  # noqa: F401
    Estimator,
    Model,
    Pipeline,
    PipelineModel,
    PipelineStage,
    Transformer,
)
from .logging import (  # noqa: F401
    InstrumentationMeasures,
    StopWatch,
    SynapseMLLogging,
    failure_counts,
    record_failure,
    reset_failure_counts,
)
from .checkpoint import (  # noqa: F401
    Checkpoint,
    CheckpointError,
    CheckpointStore,
    NonFiniteGuard,
    NonFiniteLossError,
    PreemptionError,
    atomic_write_bytes,
    atomic_write_text,
    preemption_point,
)
from .gossip import (  # noqa: F401
    ConsistentHashRing,
    GossipEntry,
    GossipState,
)
from .qos import (  # noqa: F401
    BudgetLeaseLedger,
    QoSClass,
    QoSController,
    WeightedFairQueue,
)
from .resilience import (  # noqa: F401
    DEADLINE_HEADER,
    CircuitBreaker,
    Deadline,
    Membership,
    RetryBudget,
    default_retry_budget,
)
