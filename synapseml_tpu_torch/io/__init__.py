"""IO — the serving layer: an embedded threaded HTTP server feeding
micro-batches through a fitted stage (``serving.py``), with hot swap,
tenants, deadlines and its CLI (``serving_main.py``); and the ingestion
layer of the streamed GBDT (``ingest.py``): the chunk pump, the pinned
host → card stager, the chunk geometry and the disk chunk source.

The JAX package's distributed serving (``io/distributed_serving.py``: the
forwarding gateway, worker agents, the fabric supervisor and the promotion
broadcast) is not ported yet; its names are here and raise
``NotImplementedError`` naming themselves. The HTTP client layer, the
binary and image datasources and the Power BI writer are not ported
either.
"""

from .ingest import (ChunkPump, ChunkStreamError,  # noqa: F401
                     DiskChunkSource, PinnedStager, last_chunk_decision,
                     mem_budget_bytes, pump_polling, read_chunk_file,
                     stream_chunk_rows, stream_depth)
from .serving import (ModelRegistry, ServingServer, SwapError,  # noqa: F401
                      request_to_table, respond_with)


def _unported(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (io/distributed_serving.py) is not ported to the "
            "PyTorch package yet")

    refuse.__name__ = refuse.__qualname__ = name
    return refuse


ServingGateway = _unported("ServingGateway")
WorkerAgent = _unported("WorkerAgent")
FabricSupervisor = _unported("FabricSupervisor")
PromotionBroadcast = _unported("PromotionBroadcast")
DistributedServingServer = _unported("DistributedServingServer")
federate = _unported("federate")

UNPORTED = ("ServingGateway", "WorkerAgent", "FabricSupervisor",
            "PromotionBroadcast", "DistributedServingServer", "federate")
