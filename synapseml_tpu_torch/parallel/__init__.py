from .mesh import (DATA_AXIS, SEQ_AXIS, Mesh, ShardSpec,  # noqa: F401
                   check_same_inputs, data_seq_mesh, init_distributed,
                   make_mesh, row_block, tree_shardings, zero_shard_dim,
                   zero_sharding)
from .collectives import (  # noqa: F401
    all_gather,
    all_reduce_sum,
    all_to_all,
    allgather,
    allreduce_mean,
    allreduce_sum,
    allreduce_sum_quantized,
    axis_rank,
    ppermute_next,
    probe_link_bandwidth,
    psum,
    reduce_scatter_sum,
    reduce_scatter_sum_quantized,
)
from .ring_attention import (  # noqa: F401
    attention_reference,
    blockwise_attention,
    ring_self_attention,
)
from .ulysses import ulysses_self_attention  # noqa: F401
