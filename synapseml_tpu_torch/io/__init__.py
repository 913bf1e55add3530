"""IO — the serving layer: an embedded threaded HTTP server feeding
micro-batches through a fitted stage (``serving.py``), with hot swap,
tenants, deadlines and its CLI (``serving_main.py``); and the ingestion
layer of the streamed GBDT (``ingest.py``): the chunk pump, the pinned
host → card stager, the chunk geometry and the disk chunk source.

The fabric (``distributed_serving.py``): the forwarding gateway with its
membership, routing, failover and gossip-replicated control plane,
``federate`` for peer gateways, the worker agents, the fabric supervisor,
the two-phase promotion broadcast and ``DistributedServingServer`` over
the processes of a ``torch.distributed`` world. The HTTP client layer, the
binary and image datasources and the Power BI writer are not ported.
"""

from .ingest import (ChunkPump, ChunkStreamError,  # noqa: F401
                     DiskChunkSource, PinnedStager, last_chunk_decision,
                     mem_budget_bytes, pump_polling, read_chunk_file,
                     stream_chunk_rows, stream_depth)
from .serving import (ModelRegistry, ServingServer, SwapError,  # noqa: F401
                      request_to_table, respond_with)
from .distributed_serving import (BroadcastError,  # noqa: F401
                                  CoordinatorDied, DistributedServingServer,
                                  FabricSupervisor, PromotionBroadcast,
                                  ServingGateway, WorkerAgent, federate)
