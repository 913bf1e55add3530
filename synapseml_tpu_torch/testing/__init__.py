"""Fault injection for the port's fabric, online loop and AutoML search
(``chaos.py``).

The JAX package's stage fuzzing, tolerance-CSV benchmarks, the HTTP-opener
and collective injectors, and the lock and dtype witnesses are not ported.
"""

from .chaos import (ChaosPreemption, ChaosSchedule, ChaosSwap,  # noqa: F401
                    FaultInjected, FlakyHTTPServer, bit_flip, chaos_candidate,
                    chaos_control_plane_partition, chaos_heartbeat_partition,
                    chaos_reward_stream, chaos_tenant_flood, kill_gateway,
                    kill_rank, kill_worker, torn_write)

__all__ = [
    "ChaosPreemption", "ChaosSchedule", "ChaosSwap", "FaultInjected",
    "FlakyHTTPServer", "bit_flip", "chaos_candidate",
    "chaos_control_plane_partition", "chaos_heartbeat_partition",
    "chaos_reward_stream", "chaos_tenant_flood", "kill_gateway", "kill_rank",
    "kill_worker", "torn_write",
]
