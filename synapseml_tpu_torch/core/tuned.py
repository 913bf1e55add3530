"""In-process cache of measured probes.

The port's copy of the part of the JAX package's ``core/tuned.py`` that
the distributed GBDT router reads: ``measured_or`` runs a probe once per
key and keeps its result for the life of the process. The JAX package also
persists probe results to a file and reads tuned defaults recorded on TPUs;
the port does neither (those numbers say nothing of this card), so a probe
is measured afresh in every process.

A probe that runs collectives must be asked for by every rank of its mesh
with the same key, in the same order: each rank keeps its own cache, and
the caches stay in step because the ranks make the same calls.
"""

from __future__ import annotations

_MEASUREMENTS: dict = {}


def mesh_fingerprint(mesh) -> tuple:
    """Hashable identity of a mesh for probe caching: its axes, the world
    ranks it spans and its device (stable across Mesh objects of one
    layout in one process)."""
    import torch.distributed as dist

    axes = tuple((str(k), int(v)) for k, v in dict(mesh.shape).items())
    ranks = tuple(dist.get_process_group_ranks(mesh.world_group)
                  if mesh.world_group is not None
                  else range(dist.get_world_size()))
    return axes + (ranks, str(mesh.device))


def measured_or(key, compute):
    """Get-or-measure: the cached value for ``key``, running ``compute()``
    (and caching its result) on the first call."""
    if key not in _MEASUREMENTS:
        _MEASUREMENTS[key] = compute()
    return _MEASUREMENTS[key]


def get_measurement(key, default=None):
    return _MEASUREMENTS.get(key, default)


def put_measurement(key, value) -> None:
    _MEASUREMENTS[key] = value


def clear_measurements() -> None:
    """Forget every probe result (the next ``measured_or`` measures)."""
    _MEASUREMENTS.clear()
