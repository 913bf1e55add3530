from .mesh import (DATA_AXIS, SEQ_AXIS, STAGE_AXIS, Mesh,  # noqa: F401
                   ShardSpec,
                   assert_equal_across_processes, check_same_inputs,
                   data_seq_mesh, host_copy, init_distributed,
                   initialize_distributed, local_mesh_devices, make_mesh,
                   mesh_process_indices, process_count, process_index,
                   process_topology, row_block, shard_rows, stage_submeshes,
                   to_global_rows, tree_shardings, zero_shard_dim,
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
from .transfer import device_transfer, host_fetch, share_scalars  # noqa: F401
from .elastic import (  # noqa: F401
    CollectiveWatchdog,
    ElasticUnsupportedError,
    HeartbeatMonitor,
    HeartbeatWriter,
    PeerLostError,
    TrainingSupervisor,
    consensus_restart_step,
    current_watchdog,
    elastic_train,
    elastic_watchdog,
    run_with_budget,
    verified_steps,
)
