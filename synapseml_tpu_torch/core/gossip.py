"""Replicated gateway control plane: epoch-versioned anti-entropy gossip.

One :class:`~synapseml_tpu_torch.io.distributed_serving.ServingGateway` process
owning all membership/affinity/QoS state is a single kill away from total
fabric loss. This module is the replication substrate that federates K peer
gateways: each holds a :class:`GossipState` — a key→entry map where every
entry carries a **lamport epoch** and its **origin gateway id** — and
periodically exchanges full state with one peer over the existing
``/__fabric/`` HTTP control plane (push-pull anti-entropy). Merge is
per-entry last-writer-wins on the ``(epoch, origin)`` tuple:

* the lamport clock only moves forward (every local publish bumps it past
  the newest epoch ever seen, including epochs learned from peers), so a
  gateway that HEARD about an entry and then overwrites it always wins over
  the stale original — causality is preserved without synchronized clocks;
* the origin id breaks exact epoch ties deterministically, so two gateways
  publishing concurrently converge on the SAME winner everywhere instead of
  flapping by exchange order.

Deletions are **tombstones** (``value=None``) — a real entry that must
out-gossip the data it deletes, or an evicted worker would be resurrected
by the next exchange with a peer that never heard the eviction. A later
re-publish (higher epoch) resurrects cleanly: worker rejoin just works.

What rides on it (io/distributed_serving.py): worker membership +
warm-ladder advertisements (``member/<url>``), gateway liveness
(``gateway/<id>``), tenant budget leases (``lease/<tenant>/<id>``,
core/qos.py), and two-phase promotion records (``promo/<version>``) — the
replicated prepare record a surviving peer reads to drive a dead
coordinator's broadcast round to commit or abort.

:class:`ConsistentHashRing` is the deterministic placement half:
tenant→gateway affinity that every converged gateway computes identically,
with minimal movement when a gateway dies (only the dead node's arcs
rehash — surviving tenants keep their home, so warm-ladder routing keeps
seeing stable shapes).

Thread-safe and clock-injectable; no torch, no sockets — transport belongs
to the gateway (chaos partitions it via ``_GOSSIP_HOOK`` there).
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class GossipEntry:
    """One replicated fact. ``value=None`` is a tombstone (the deletion
    itself replicates). ``(epoch, origin)`` totally orders conflicting
    writes to the same key fabric-wide."""

    key: str
    value: Optional[dict]
    epoch: int
    origin: str

    def wire(self) -> dict:
        return {"key": self.key, "value": self.value,
                "epoch": self.epoch, "origin": self.origin}

    @classmethod
    def from_wire(cls, d: dict) -> "GossipEntry":
        value = d.get("value")
        return cls(key=str(d["key"]),
                   value=dict(value) if isinstance(value, dict) else None,
                   epoch=int(d["epoch"]), origin=str(d.get("origin", "")))


def _wins(challenger: GossipEntry, incumbent: Optional[GossipEntry]) -> bool:
    """Does ``challenger`` replace ``incumbent``? Strict — an identical
    (epoch, origin) re-delivery is a no-op, so exchanges are idempotent."""
    if incumbent is None:
        return True
    return (challenger.epoch, challenger.origin) > \
        (incumbent.epoch, incumbent.origin)


class GossipState:
    """Epoch-versioned replicated map for one gateway.

    * :meth:`publish` / :meth:`retract` — local writes; each bumps the
      lamport clock past everything this node has ever seen, stamping the
      entry so it wins over any state the write is based on.
    * :meth:`merge` — apply a peer's entries; per-entry ``(epoch, origin)``
      tie-breaking makes merge commutative, associative and idempotent
      (anti-entropy converges regardless of exchange order or repeats).
    * :meth:`advanced_at` — the LOCAL monotonic instant a key last advanced
      (changed epoch). Budget leases expire on this: a dead leaseholder's
      entries stop advancing everywhere, no cross-host clock comparison
      needed (core/qos.py, :class:`~synapseml_tpu_torch.core.qos.BudgetLease`).
    * replication-lag accounting — peers' lamport clocks ride every
      exchange (:meth:`observe_peer_clock`); ``entries_behind`` =
      newest clock known anywhere minus what this node has merged, the
      health-endpoint number that shows a partition before it bites.
    """

    def __init__(self, node_id: str, clock=time.monotonic):
        if not node_id:
            raise ValueError("GossipState needs a non-empty node_id")
        self.node_id = str(node_id)
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: Dict[str, GossipEntry] = {}
        self._lamport = 0
        self._advanced_at: Dict[str, float] = {}
        self._peer_clocks: Dict[str, int] = {}
        self.published = 0
        self.merged_in = 0          # entries accepted from peers
        self.stale_dropped = 0      # entries offered but already superseded

    # -- local writes -----------------------------------------------------
    def publish(self, key: str, value: Optional[dict]) -> GossipEntry:
        """Write ``key`` locally; the new entry's epoch is newer than every
        epoch this node has seen, so it supersedes whatever it read."""
        with self._lock:
            self._lamport += 1
            entry = GossipEntry(key=str(key),
                                value=dict(value) if value is not None
                                else None,
                                epoch=self._lamport, origin=self.node_id)
            self._entries[entry.key] = entry
            self._advanced_at[entry.key] = self._clock()
            self.published += 1
            return entry

    def retract(self, key: str) -> GossipEntry:
        """Delete via tombstone — the deletion replicates like any write."""
        return self.publish(key, None)

    # -- anti-entropy -----------------------------------------------------
    def merge(self, entries: Iterable) -> List[GossipEntry]:
        """Apply a peer's entries (wire dicts or :class:`GossipEntry`);
        returns those accepted (newer than local state). The lamport clock
        advances to the newest epoch seen, so later local writes supersede
        everything merged here."""
        accepted: List[GossipEntry] = []
        with self._lock:
            for raw in entries:
                entry = raw if isinstance(raw, GossipEntry) \
                    else GossipEntry.from_wire(raw)
                if entry.epoch > self._lamport:
                    self._lamport = entry.epoch
                if _wins(entry, self._entries.get(entry.key)):
                    self._entries[entry.key] = entry
                    self._advanced_at[entry.key] = self._clock()
                    self.merged_in += 1
                    accepted.append(entry)
                else:
                    self.stale_dropped += 1
        return accepted

    def wire(self) -> List[dict]:
        """Full state in wire form (tombstones included — they must
        out-gossip what they delete)."""
        with self._lock:
            return [e.wire() for e in self._entries.values()]

    # -- reads ------------------------------------------------------------
    def get(self, key: str) -> Optional[dict]:
        """Live value for ``key`` (None for absent OR tombstoned)."""
        with self._lock:
            entry = self._entries.get(key)
            return dict(entry.value) if entry is not None \
                and entry.value is not None else None

    def entry(self, key: str) -> Optional[GossipEntry]:
        with self._lock:
            return self._entries.get(key)

    def items(self, prefix: str = "") -> Dict[str, dict]:
        """Live (non-tombstoned) entries under ``prefix``."""
        with self._lock:
            return {k: dict(e.value) for k, e in self._entries.items()
                    if e.value is not None and k.startswith(prefix)}

    def advanced_at(self, key: str) -> Optional[float]:
        """LOCAL monotonic time ``key`` last changed epoch here (publish or
        accepted merge) — the liveness signal leases expire on."""
        with self._lock:
            return self._advanced_at.get(key)

    @property
    def lamport(self) -> int:
        with self._lock:
            return self._lamport

    # -- replication-lag accounting --------------------------------------
    def observe_peer_clock(self, peer: str, clock: int) -> None:
        """Record a peer's advertised lamport clock (rides every gossip
        request AND reply, so one-way partitions still surface lag)."""
        with self._lock:
            if clock > self._peer_clocks.get(peer, -1):
                self._peer_clocks[peer] = int(clock)

    def entries_behind(self) -> int:
        """How far behind the newest epoch known ANYWHERE this node is —
        0 when converged; grows while a partition withholds exchanges."""
        with self._lock:
            newest = max(self._peer_clocks.values(), default=0)
            return max(0, newest - self._lamport)

    def peer_clocks(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._peer_clocks)

    def snapshot(self) -> dict:
        with self._lock:
            live = sum(1 for e in self._entries.values()
                       if e.value is not None)
            newest = max(self._peer_clocks.values(), default=0)
            return {"node_id": self.node_id, "clock": self._lamport,
                    "entries": live,
                    "tombstones": len(self._entries) - live,
                    "published": self.published,
                    "merged_in": self.merged_in,
                    "stale_dropped": self.stale_dropped,
                    "entries_behind": max(0, newest - self._lamport)}


class ConsistentHashRing:
    """Deterministic key→node placement with minimal movement on node
    death: each node owns ``vnodes`` pseudo-random arcs of a sha1 ring, a
    key maps to the first arc clockwise of its hash. Removing a node
    reassigns ONLY that node's arcs (≈1/K of keys); every other key keeps
    its node — the property tenant→gateway affinity needs so a gateway
    death rehomes only the dead gateway's tenants, with every surviving
    gateway computing the SAME new homes from converged membership.
    """

    def __init__(self, nodes: Sequence[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._lock = threading.Lock()
        self._points: List[Tuple[int, str]] = []   # sorted (hash, node)
        self._nodes: set = set()
        for n in nodes:
            self.add(n)

    @staticmethod
    def _hash(data: str) -> int:
        return int.from_bytes(
            hashlib.sha1(data.encode()).digest()[:8], "big")

    def add(self, node: str) -> bool:
        node = str(node)
        with self._lock:
            if node in self._nodes:
                return False
            self._nodes.add(node)
            for i in range(self.vnodes):
                bisect.insort(self._points,
                              (self._hash(f"{node}#{i}"), node))
            return True

    def remove(self, node: str) -> bool:
        node = str(node)
        with self._lock:
            if node not in self._nodes:
                return False
            self._nodes.discard(node)
            self._points = [p for p in self._points if p[1] != node]
            return True

    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    def __len__(self) -> int:
        with self._lock:
            return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        with self._lock:
            return node in self._nodes

    def node_for(self, key: str, exclude: Sequence[str] = ()
                 ) -> Optional[str]:
        """Owning node for ``key`` — first arc clockwise of the key's hash,
        skipping ``exclude`` (walk on: the deterministic failover order).
        None when no eligible node remains."""
        skip = set(exclude)
        with self._lock:
            if not self._points:
                return None
            start = bisect.bisect(self._points, (self._hash(str(key)), ""))
            n = len(self._points)
            for off in range(n):
                node = self._points[(start + off) % n][1]
                if node not in skip:
                    return node
            return None
