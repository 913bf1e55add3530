from .mesh import (DATA_AXIS, SEQ_AXIS, Mesh, ShardSpec,  # noqa: F401
                   data_seq_mesh, init_distributed, make_mesh,
                   tree_shardings, zero_shard_dim, zero_sharding)
from .collectives import (all_gather, all_reduce_sum, all_to_all,  # noqa: F401
                          ppermute_next, psum)
from .ring_attention import (  # noqa: F401
    attention_reference,
    blockwise_attention,
    ring_self_attention,
)
from .ulysses import ulysses_self_attention  # noqa: F401
