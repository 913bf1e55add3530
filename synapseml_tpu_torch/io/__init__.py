"""IO — the serving layer: an embedded threaded HTTP server feeding
micro-batches through a fitted stage (``serving.py``), with hot swap,
tenants, deadlines and its CLI (``serving_main.py``); and the ingestion
layer of the streamed GBDT (``ingest.py``): the chunk pump, the pinned
host → card stager, the chunk geometry and the disk chunk source.

The fabric (``distributed_serving.py``): the forwarding gateway with its
membership, routing, failover and gossip-replicated control plane,
``federate`` for peer gateways, the worker agents, the fabric supervisor,
the two-phase promotion broadcast and ``DistributedServingServer`` over
the processes of a ``torch.distributed`` world.

The HTTP-on-Table client layer (``http.py``: ``HTTPTransformer``,
``SimpleHTTPTransformer``, the parsers, ``send_with_retries`` on one shared
opener), the websocket client under the streaming Speech SDK
(``websocket.py``), the binary and image datasources (``binary.py``) and
the Power BI writer (``powerbi.py``): host code, copies of the JAX
package's modules.
"""

from .http import (CustomInputParser, CustomOutputParser,  # noqa: F401
                   HTTPRequestData, HTTPResponseData, HTTPTransformer,
                   JSONInputParser, JSONOutputParser, SimpleHTTPTransformer,
                   StringOutputParser)
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
from .binary import read_binary_files, read_image_dir  # noqa: F401
from .powerbi import PowerBIWriter  # noqa: F401

__all__ = [
    "HTTPRequestData", "HTTPResponseData", "HTTPTransformer",
    "SimpleHTTPTransformer", "JSONInputParser", "CustomInputParser",
    "JSONOutputParser", "StringOutputParser", "CustomOutputParser",
    "ServingServer", "ServingGateway", "DistributedServingServer",
    "WorkerAgent", "FabricSupervisor", "ModelRegistry", "SwapError",
    "PromotionBroadcast", "BroadcastError", "CoordinatorDied", "federate",
    "request_to_table", "respond_with",
    "read_binary_files", "read_image_dir", "PowerBIWriter",
]
