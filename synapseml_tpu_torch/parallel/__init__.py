from .mesh import (DATA_AXIS, SEQ_AXIS, Mesh, data_seq_mesh,  # noqa: F401
                   init_distributed, make_mesh)
from .collectives import (all_gather, all_reduce_sum, all_to_all,  # noqa: F401
                          ppermute_next)
from .ring_attention import (  # noqa: F401
    attention_reference,
    blockwise_attention,
    ring_self_attention,
)
from .ulysses import ulysses_self_attention  # noqa: F401
