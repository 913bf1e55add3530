from .mesh import DATA_AXIS, SEQ_AXIS, Mesh, init_distributed, make_mesh  # noqa: F401
from .collectives import all_gather, all_to_all, ppermute_next  # noqa: F401
from .ring_attention import (  # noqa: F401
    attention_reference,
    blockwise_attention,
    ring_self_attention,
)
from .ulysses import ulysses_self_attention  # noqa: F401
