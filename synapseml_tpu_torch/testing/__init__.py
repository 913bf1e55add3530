"""Fault injection for the port's HTTP clients, fabric, online loop and
AutoML search (``chaos.py``).

The JAX package's stage fuzzing, tolerance-CSV benchmarks, the collective,
NaN-batch, chunk-stream and hang injectors, and the lock and dtype witnesses
are not ported.
"""

from .chaos import (ChaosHTTP, ChaosPreemption, ChaosSchedule,  # noqa: F401
                    ChaosSwap, FaultInjected, FlakyHTTPServer, bit_flip,
                    canned_json_responder, chaos_candidate, chaotic_handler,
                    chaos_control_plane_partition, chaos_heartbeat_partition,
                    chaos_reward_stream, chaos_tenant_flood, kill_gateway,
                    kill_rank, kill_worker, torn_write)

__all__ = [
    "ChaosHTTP", "canned_json_responder", "chaotic_handler",
    "ChaosPreemption", "ChaosSchedule", "ChaosSwap", "FaultInjected",
    "FlakyHTTPServer", "bit_flip", "chaos_candidate",
    "chaos_control_plane_partition", "chaos_heartbeat_partition",
    "chaos_reward_stream", "chaos_tenant_flood", "kill_gateway", "kill_rank",
    "kill_worker", "torn_write",
]
