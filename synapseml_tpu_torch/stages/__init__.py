"""Generic pipeline stages.

Analogs of the reference's ``core/.../stages/`` package (21 files,
SURVEY.md §2.7): mini-batching, flattening, UDF application, repartitioning,
column plumbing, text preprocessing, summarization, and class balancing —
re-expressed over the columnar :class:`~synapseml_tpu_torch.core.table.Table` instead
of Spark DataFrames. Batching here feeds captured device programs (fixed shapes),
which is why FixedMiniBatchTransformer supports padding to a static batch size.

The port's copy of the JAX package's ``stages/__init__.py`` (host code; the
port imports nothing of that package).
"""

from .batchers import (  # noqa: F401
    DynamicMiniBatchTransformer,
    FixedMiniBatchTransformer,
    FlattenBatch,
    TimeIntervalMiniBatchTransformer,
)
from .basic import (  # noqa: F401
    Cacher,
    DropColumns,
    Explode,
    Lambda,
    RenameColumn,
    SelectColumns,
    Repartition,
    Timer,
    UDFTransformer,
)
from .balance import ClassBalancer, ClassBalancerModel, StratifiedRepartition  # noqa: F401
from .ensemble import EnsembleByKey, PartitionConsolidator  # noqa: F401
from .text import TextPreprocessor, UnicodeNormalize  # noqa: F401
from .summarize import SummarizeData  # noqa: F401
from .adapter import MultiColumnAdapter  # noqa: F401
