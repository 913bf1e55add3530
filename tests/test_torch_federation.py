"""The port's federated gateway tier on the CPU: the scenarios of the JAX
package's federation suite, run on the port's gateways, gossip state, ring,
lease ledger, promotion broadcast and chaos injectors alone.

No single point of failure in the serving fabric:

* the replicated control plane (core/gossip.py) converges membership,
  liveness, leases and promotion records across K peer gateways — merge is
  commutative/idempotent, ties break deterministically, tombstones beat
  the data they delete, and resurrection (worker rejoin) wins by epoch,
* consistent-hash tenant→gateway affinity moves ONLY the dead gateway's
  tenants on a kill,
* edge-tier token buckets enforce ONE global per-tenant rate as leased
  sub-budgets: shares split live, and a dead leaseholder's slice expires
  closed (under-admission, never over-admission) and is reabsorbed,
* PromotionBroadcast survives coordinator death mid-round: a surviving
  peer reads the replicated 2PC phase record and drives the round to
  commit (``prepared``) or abort (``preparing``) — one version fabric-wide,
* workers orphaned by a gateway kill re-home to a surviving gateway within
  one heartbeat interval (jittered failover, peers learned from acks),
* and the fabric invariant holds across any single-gateway kill — mid-route,
  mid-lease, mid-broadcast: zero 5xx for accepted requests (clients retry
  connection errors against survivors) and exactly one gate-approved
  version serving fabric-wide.

Every wait polls a condition with a deadline (``_wait``). The
control-plane partition case runs its gateways on a shared fake clock
that only the test advances, so peer death and healing do not depend on
how fast the replicator threads run under load.
"""

from __future__ import annotations

import threading
import time

import pytest

from synapseml_tpu_torch.core import (BudgetLeaseLedger, ConsistentHashRing,
                                GossipState, QoSClass, QoSController,
                                reset_failure_counts)
from synapseml_tpu_torch.core.qos import TENANT_HEADER
from synapseml_tpu_torch.io.distributed_serving import (CoordinatorDied,
                                                  PromotionBroadcast,
                                                  ServingGateway, WorkerAgent,
                                                  federate)
from synapseml_tpu_torch.io.serving import ModelRegistry, ServingServer
from synapseml_tpu_torch.testing.chaos import (chaos_control_plane_partition,
                                         kill_gateway)

from torch_fabric import echo as _echo, post as _post
from torch_waits import join_thread, join_threads


@pytest.fixture(autouse=True)
def _clean_counters():
    reset_failure_counts()
    yield


def _wait(pred, timeout=6.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def _mk_gateways(n, worker_urls, **kw):
    """Start n federated gateways over the same worker set, fast gossip."""
    kw.setdefault("gossip_interval", 0.05)
    kw.setdefault("peer_timeout", 0.4)
    gws = [ServingGateway(worker_urls, port=0, **kw).start()
           for _ in range(n)]
    federate(gws)
    return gws


def _stop_all(gws):
    for gw in gws:
        try:
            gw.stop()
        except Exception:  # noqa: BLE001 — killed gateways already closed
            pass


def _converged(gws):
    """Every gateway sees every other alive and the rings agree."""
    want = sorted(gw.public_url for gw in gws)
    for gw in gws:
        peers = gw._peers_alive(gw._clock())
        if len(peers) != len(gws) - 1:
            return False
        if not all(p["alive"] for p in peers.values()):
            return False
        if sorted(gw.ring.nodes()) != want:
            return False
    return True


def _load_federated(urls, n, value="x", timeout=10.0):
    """Fire n concurrent POSTs, each retrying across the gateway list on a
    CONNECTION error (the dead-gateway case: the client never got a status,
    so retrying on a survivor is safe and is what a fleet LB does). A
    request that got no definite status from ANY gateway is a drop — the
    thing the fabric invariant forbids."""
    results, dropped = [], []
    lock = threading.Lock()

    def one(i):
        last = None
        for attempt in range(len(urls) + 2):
            url = urls[(i + attempt) % len(urls)]
            try:
                r = _post(url, value, timeout=timeout)
                with lock:
                    results.append(r)
                return
            except Exception as e:  # noqa: BLE001 — dead gateway: retry next
                last = e
        with lock:
            dropped.append((i, repr(last)))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    join_threads(threads, what="federated load clients")
    return results, dropped


def _assert_zero_5xx(results, dropped):
    assert not dropped, f"requests dropped by every gateway: {dropped}"
    bad = [s for s, _, _ in results if s not in (200, 429, 503, 504)]
    assert not bad, f"5xx leaked to accepted requests: {bad}"


# --------------------------------------------------------------------------
# gossip substrate
# --------------------------------------------------------------------------

class TestGossipState:
    def test_exchange_converges_both_sides(self):
        a, b = GossipState("a"), GossipState("b")
        a.publish("member/w1", {"q": 1})
        b.publish("member/w2", {"q": 2})
        # one push-pull round: b merges a's state, a merges b's reply
        b.merge(a.wire())
        a.merge(b.wire())
        assert a.items() == b.items()
        assert set(a.items()) == {"member/w1", "member/w2"}

    def test_later_overwrite_beats_original(self):
        a, b = GossipState("a"), GossipState("b")
        a.publish("k", {"v": "old"})
        b.merge(a.wire())
        # b HEARD the entry, then overwrites: lamport moved past a's epoch,
        # so b's version wins everywhere — causality without clocks
        b.publish("k", {"v": "new"})
        a.merge(b.wire())
        assert a.get("k") == {"v": "new"}
        assert b.get("k") == {"v": "new"}

    def test_concurrent_tie_breaks_on_origin_everywhere(self):
        a, b = GossipState("a"), GossipState("b")
        a.publish("k", {"who": "a"})        # epoch 1 @ a
        b.publish("k", {"who": "b"})        # epoch 1 @ b — exact tie
        a.merge(b.wire())
        b.merge(a.wire())
        # both converge on the SAME winner (greater origin id), no flapping
        assert a.get("k") == b.get("k") == {"who": "b"}

    def test_tombstone_deletes_then_rejoin_resurrects(self):
        a, b = GossipState("a"), GossipState("b")
        a.publish("member/w", {"q": 0})
        b.merge(a.wire())
        a.retract("member/w")
        b.merge(a.wire())
        assert b.get("member/w") is None     # deletion replicated
        # rejoin: a later publish out-epochs the tombstone
        b.publish("member/w", {"q": 5})
        a.merge(b.wire())
        assert a.get("member/w") == {"q": 5}

    def test_merge_is_idempotent(self):
        a, b = GossipState("a"), GossipState("b")
        a.publish("k", {"v": 1})
        wire = a.wire()
        assert len(b.merge(wire)) == 1
        assert b.merge(wire) == []           # re-delivery is a no-op
        assert b.stale_dropped == 1

    def test_entries_behind_tracks_replication_lag(self):
        a = GossipState("a")
        a.publish("k", {"v": 1})
        a.observe_peer_clock("b", 9)
        assert a.entries_behind() == 8
        a.merge([{"key": "k2", "value": {}, "epoch": 9, "origin": "b"}])
        assert a.entries_behind() == 0
        assert a.snapshot()["entries_behind"] == 0


class TestConsistentHashRing:
    def test_placement_is_deterministic_across_instances(self):
        nodes = ["http://g1:1", "http://g2:1", "http://g3:1"]
        r1, r2 = ConsistentHashRing(nodes), ConsistentHashRing(nodes)
        for k in range(100):
            assert r1.node_for(f"tenant-{k}") == r2.node_for(f"tenant-{k}")

    def test_removal_moves_only_dead_nodes_keys(self):
        nodes = ["http://g1:1", "http://g2:1", "http://g3:1"]
        ring = ConsistentHashRing(nodes)
        before = {f"t{k}": ring.node_for(f"t{k}") for k in range(300)}
        ring.remove("http://g2:1")
        moved = 0
        for key, owner in before.items():
            now = ring.node_for(key)
            if owner == "http://g2:1":
                assert now != "http://g2:1"   # dead node's keys rehome
                moved += 1
            else:
                assert now == owner           # everyone else stays put
        assert 0 < moved < 300                # the dead node owned SOME keys

    def test_exclude_walks_to_next_arc(self):
        ring = ConsistentHashRing(["a", "b"])
        home = ring.node_for("k")
        other = ring.node_for("k", exclude=[home])
        assert other is not None and other != home
        assert ring.node_for("k", exclude=["a", "b"]) is None


# --------------------------------------------------------------------------
# budget leases: K gateways, one global per-tenant rate
# --------------------------------------------------------------------------

class TestBudgetLeases:
    def test_share_splits_live_and_regrows_after_death(self):
        t = [0.0]
        led = BudgetLeaseLedger(ttl=1.0, clock=lambda: t[0])
        led.observe("acme", "g1")
        led.observe("acme", "g2")
        assert led.share("acme", "g1") == 0.5          # two live enforcers
        # g2 dies: its entry stops advancing; g1 keeps renewing
        t[0] = 0.9
        led.observe("acme", "g1")
        assert led.share("acme", "g1") == 0.5          # not yet expired
        t[0] = 2.0
        led.observe("acme", "g1")
        assert led.share("acme", "g1") == 1.0          # slice reabsorbed
        assert led.expired == 1

    def test_share_counts_self_before_first_advance(self):
        led = BudgetLeaseLedger(ttl=1.0)
        # asking for a share IS holding a lease — never divides by zero
        assert led.share("acme", "g1") == 1.0

    def test_rate_share_halves_the_edge_bucket(self):
        t = [0.0]
        qos = QoSController(
            default_class=QoSClass(rate_per_sec=10.0, burst=4.0),
            clock=lambda: t[0])
        qos.set_rate_share("acme", 0.5)
        # leased burst = 4 * 0.5 = 2 tokens at this edge
        assert qos.admit("acme").ok
        assert qos.admit("acme").ok
        denied = qos.admit("acme")
        assert not denied.ok and denied.status == 429
        # refill runs at share * global rate: after 0.2s only 10*0.5*0.2=1
        t[0] = 0.2
        assert qos.admit("acme").ok
        assert not qos.admit("acme").ok
        # lease expiry grows the share back: full burst again
        qos.set_rate_share("acme", 1.0)
        t[0] = 10.0
        for _ in range(4):
            assert qos.admit("acme").ok
        assert not qos.admit("acme").ok


# --------------------------------------------------------------------------
# federated membership: any gateway routes to any worker
# --------------------------------------------------------------------------

class TestFederatedMembership:
    def test_heartbeat_on_one_gateway_replicates_to_peers(self):
        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w1, \
                ServingServer(_echo, port=0, max_batch_latency=0.0) as w2:
            gw1 = ServingGateway([w1.url], port=0,
                                 gossip_interval=0.05).start()
            gw2 = ServingGateway([w2.url], port=0,
                                 gossip_interval=0.05).start()
            try:
                federate([gw1, gw2])
                # w1 heartbeats ONLY to gw1; gossip must teach gw2
                agent = WorkerAgent(w1, gw1.url, interval=0.05)
                agent.start()
                try:
                    assert _wait(lambda: any(
                        l.url == agent.advertise_url for l in gw2.links))
                    assert gw2.membership.alive(agent.advertise_url)
                    # gw2 can now route — through EITHER worker
                    status, body, _ = _post(gw2.url, "via-gw2")
                    assert status == 200
                    # eviction replicates as a tombstone: clean leave at
                    # gw1 disappears from gw2 too
                    agent.stop()             # deregisters at gw1
                    assert _wait(lambda: not any(
                        l.url == agent.advertise_url for l in gw2.links))
                finally:
                    agent.stop(deregister=False)
            finally:
                _stop_all([gw1, gw2])

    def test_converged_gateways_agree_on_tenant_homes(self):
        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w:
            gws = _mk_gateways(3, [w.url])
            try:
                assert _wait(lambda: _converged(gws))
                for tenant in ("acme", "blue", "green", "zeta"):
                    homes = {gw.tenant_home(tenant) for gw in gws}
                    assert len(homes) == 1, \
                        f"{tenant} homes disagree: {homes}"
            finally:
                _stop_all(gws)

    def test_health_endpoint_reports_federation_state(self):
        import json
        import urllib.request

        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w:
            gws = _mk_gateways(2, [w.url])
            try:
                assert _wait(lambda: _converged(gws))
                with urllib.request.urlopen(
                        f"http://{gws[0].host}:{gws[0].port}/",
                        timeout=5) as r:
                    health = json.loads(r.read().decode())
                fed = health["federation"]
                assert fed["gateway_id"] == gws[0].gateway_id
                assert fed["entries_behind"] == 0          # converged
                assert len(fed["peers"]) == 1
                peer = next(iter(fed["peers"].values()))
                assert peer["alive"] and peer["url"] == gws[1].public_url
                assert sorted(fed["ring"]) == sorted(
                    gw.public_url for gw in gws)
                assert fed["gossip"]["merged_in"] > 0
            finally:
                _stop_all(gws)

    def test_control_plane_partition_marks_peer_dead_then_heals(self):
        # liveness is judged on the gateways' clock: a shared fake clock
        # that moves only here makes death and healing independent of the
        # replicator threads' speed (the wall-clock version of this case is
        # flaky under a loaded machine)
        t = [0.0]

        def dead_alone():
            t[0] += 0.5              # past peer_timeout at every poll
            return (not any(p["alive"] for p in gws[0]._peers_alive(
                gws[0]._clock()).values())
                and gws[0].ring.nodes() == [gws[0].public_url])

        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w:
            gws = _mk_gateways(2, [w.url], peer_timeout=0.3,
                               clock=lambda: t[0])
            try:
                assert _wait(lambda: _converged(gws), timeout=20.0)
                with chaos_control_plane_partition() as part:
                    # liveness entries stop advancing: the peer goes dead
                    # and its arcs leave the ring — split-brain, but each
                    # side keeps serving from its last converged state
                    assert _wait(dead_alone, timeout=20.0)
                    status, _, _ = _post(gws[0].url, "during-partition")
                    assert status == 200
                    assert part.dropped      # exchanges really were cut
                    part.heal()
                    # anti-entropy is idempotent: healing just drains lag
                    assert _wait(lambda: _converged(gws), timeout=20.0)
            finally:
                _stop_all(gws)


# --------------------------------------------------------------------------
# worker failover: orphaned workers re-home within one heartbeat interval
# --------------------------------------------------------------------------

class TestWorkerFailover:
    def test_agent_learns_peer_gateways_from_ack(self):
        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w:
            gws = _mk_gateways(2, [w.url])
            try:
                assert _wait(lambda: _converged(gws))
                agent = WorkerAgent(w, gws[0].url)   # knows ONE gateway
                assert agent.beat()
                assert len(agent.gateways()) == 2    # ack taught the rest
            finally:
                _stop_all(gws)

    def test_beat_fails_over_to_survivor_same_beat(self):
        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w:
            gws = _mk_gateways(2, [w.url])
            try:
                agent = WorkerAgent(w, [gws[0].url, gws[1].url],
                                    interval=0.1, failover_backoff=0.01)
                assert agent.beat() and agent.failed_over == 0
                kill_gateway(gws[0])
                # the SAME beat call retries the survivor — no lost beat
                assert agent.beat()
                assert agent.failed_over == 1
                assert agent.failed == 0
                assert gws[1].membership.alive(agent.advertise_url)
                # re-homed: subsequent beats go straight to the survivor
                assert agent.beat() and agent.failed_over == 1
            finally:
                _stop_all(gws)

    def test_orphans_rehome_within_one_heartbeat_interval(self):
        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w:
            gws = _mk_gateways(2, [w.url])
            try:
                assert _wait(lambda: _converged(gws))
                interval = 0.15
                agent = WorkerAgent(w, gws[0].url, interval=interval,
                                    failover_backoff=0.01).start()
                try:
                    assert _wait(lambda: agent.sent >= 1)
                    kill_gateway(gws[0])
                    t0 = time.time()
                    assert _wait(lambda: agent.failed_over >= 1,
                                 timeout=5.0)
                    # one interval (+ the beat's own jittered retry) is the
                    # re-home bound; 3x is comfortable slack on CI
                    assert time.time() - t0 < 3 * interval + 1.0
                    assert gws[1].membership.alive(agent.advertise_url)
                finally:
                    agent.stop(deregister=False)
            finally:
                _stop_all(gws)


# --------------------------------------------------------------------------
# promotion broadcast: coordinator death mid-round, surviving-peer recovery
# --------------------------------------------------------------------------

def _mk_registries(n, version="v1"):
    servers = [ServingServer(_echo) for _ in range(n)]   # not started
    return servers, [ModelRegistry(s, version=version) for s in servers]


def _run_to_death(coord, version, handler=_echo):
    """Run a broadcast on its own thread until CoordinatorDied, then join
    (take_over_staged requires the owning thread provably dead)."""
    errs = []

    def run():
        try:
            coord.broadcast(version, handler)
        except CoordinatorDied as e:
            errs.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert errs, "broadcast should have died with CoordinatorDied"


class TestBroadcastRecovery:
    def test_death_after_prepared_recovers_forward(self):
        _, regs = _mk_registries(3)
        control = GossipState("ctl")
        # alive() is probed once per registry per phase: 3 prepares, then
        # the commits. Die before the SECOND commit — the worst case: one
        # worker already flipped, two stranded mid-stage.
        calls = [0]

        def alive():
            calls[0] += 1
            return calls[0] <= 4

        coord = PromotionBroadcast(regs, control=control,
                                   node_id="coordinator", alive=alive)
        _run_to_death(coord, "v2")
        actives = [r.active for r in regs]
        assert actives.count("v2") == 1        # mixed fabric mid-death
        # the replicated record holds the decision: prepared = commit
        survivor = PromotionBroadcast(regs, control=control,
                                      node_id="survivor")
        assert survivor.in_doubt() == ("v2", "prepared")
        assert survivor.recover() == ("v2", "committed")
        assert survivor.converged()
        assert all(r.active == "v2" for r in regs)
        assert survivor.recoveries == 1
        # the final phase replicated: other survivors do not re-recover
        assert survivor.in_doubt() is None
        assert survivor.recover() is None

    def test_death_mid_prepare_recovers_backward(self):
        _, regs = _mk_registries(3)
        control = GossipState("ctl")
        calls = [0]

        def alive():
            calls[0] += 1
            return calls[0] <= 1       # die after the FIRST prepare

        coord = PromotionBroadcast(regs, control=control,
                                   node_id="coordinator", alive=alive)
        _run_to_death(coord, "v2")
        # no decision record: the round never reached "prepared", so a
        # survivor must converge BACKWARD — old version everywhere
        survivor = PromotionBroadcast(regs, control=control,
                                      node_id="survivor")
        assert survivor.in_doubt() == ("v2", "preparing")
        assert survivor.recover() == ("v2", "aborted")
        assert survivor.converged()
        assert all(r.active == "v1" for r in regs)
        # the orphaned stage was adopted and discarded: a NEW broadcast
        # can run (the swap lock is not stranded forever)
        fresh = PromotionBroadcast(regs)
        assert fresh.broadcast("v3", _echo) == "v3"
        assert all(r.active == "v3" for r in regs)

    def test_recover_is_noop_without_a_pending_round(self):
        _, regs = _mk_registries(2)
        survivor = PromotionBroadcast(regs, control=GossipState("ctl"))
        assert survivor.in_doubt() is None
        assert survivor.recover() is None
        # and entirely absent without a control plane (legacy mode)
        assert PromotionBroadcast(regs).in_doubt() is None
        assert PromotionBroadcast(regs).recover() is None


# --------------------------------------------------------------------------
# the federation fabric invariant: any single-gateway kill
# --------------------------------------------------------------------------

class TestGatewayKillInvariant:
    def test_kill_mid_route_zero_5xx_for_accepted(self):
        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w1, \
                ServingServer(_echo, port=0, max_batch_latency=0.0) as w2:
            gws = _mk_gateways(3, [w1.url, w2.url])
            try:
                assert _wait(lambda: _converged(gws))
                urls = [gw.url for gw in gws]
                killer = threading.Timer(0.05, kill_gateway, (gws[0],))
                killer.start()
                results, dropped = _load_federated(urls, 48)
                join_thread(killer, what="the gateway killer")
                _assert_zero_5xx(results, dropped)
                assert len(results) == 48
                # the survivors carried the load
                ok = [s for s, _, _ in results if s == 200]
                assert ok, "no request succeeded on the survivors"
            finally:
                _stop_all(gws)

    def test_kill_mid_lease_budget_reconverges_closed(self):
        mk_qos = lambda: QoSController(  # noqa: E731
            default_class=QoSClass(rate_per_sec=200.0, burst=64.0))
        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w:
            gw1 = ServingGateway([w.url], port=0, gossip_interval=0.05,
                                 peer_timeout=0.4, lease_ttl=0.5,
                                 qos=mk_qos()).start()
            gw2 = ServingGateway([w.url], port=0, gossip_interval=0.05,
                                 peer_timeout=0.4, lease_ttl=0.5,
                                 qos=mk_qos()).start()
            try:
                federate([gw1, gw2])
                assert _wait(lambda: _converged([gw1, gw2]))
                hdr = {TENANT_HEADER: "acme"}
                # touch the tenant at BOTH edges: two live leaseholders,
                # each enforcing half the global contract
                assert _post(gw1.url, "a", headers=hdr)[0] == 200
                assert _post(gw2.url, "b", headers=hdr)[0] == 200
                assert _wait(lambda:
                             gw1.qos.rate_share("acme") == 0.5 and
                             gw2.qos.rate_share("acme") == 0.5)
                # kill one leaseholder mid-lease: its entry stops
                # advancing; the window errs CLOSED (share stays <= 1.0
                # fabric-wide), then the survivor reabsorbs the slice
                kill_gateway(gw2)

                def survivor_full_share():
                    _post(gw1.url, "keepalive", headers=hdr)
                    return gw1.qos.rate_share("acme") == 1.0

                assert _wait(survivor_full_share, timeout=8.0)
                assert gw1.leases.holders("acme") == [gw1.gateway_id]
                assert _post(gw1.url, "after", headers=hdr)[0] == 200
            finally:
                _stop_all([gw1, gw2])

    def test_kill_coordinator_mid_broadcast_one_version_fabric_wide(self):
        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w1, \
                ServingServer(_echo, port=0, max_batch_latency=0.0) as w2:
            regs = [ModelRegistry(w1, version="v1"),
                    ModelRegistry(w2, version="v1")]
            gws = _mk_gateways(2, [w1.url, w2.url])
            gw1, gw2 = gws
            try:
                assert _wait(lambda: _converged(gws))

                def alive_probe():
                    # the chaos trigger: once the round's DECISION record
                    # ("prepared") exists, hold the coordinator until the
                    # survivor has replicated it, then kill — the
                    # worst-case instant (decision made, nothing
                    # committed, every stage stranded)
                    if not gw1.alive():
                        return False
                    rec = gw1.gossip.get("promo/v2")
                    if rec is not None and rec.get("phase") == "prepared":
                        assert _wait(lambda: (gw2.gossip.get("promo/v2")
                                              or {}).get("phase")
                                     == "prepared")
                        kill_gateway(gw1)
                        return False
                    return True

                coord = PromotionBroadcast(regs, control=gw1.gossip,
                                           node_id=gw1.gateway_id,
                                           alive=alive_probe)
                _run_to_death(coord, "v2")
                # the surviving gateway recovers from ITS replica of the
                # phase record — the real replication path, not a shared
                # object
                survivor = PromotionBroadcast(regs, control=gw2.gossip,
                                              node_id=gw2.gateway_id,
                                              alive=gw2.alive)
                assert survivor.recover() == ("v2", "committed")
                assert survivor.converged()
                assert {r.active for r in regs} == {"v2"}
                # exactly one gate-approved version serves: requests
                # through the surviving gateway hit committed workers only
                status, _, _ = _post(gw2.url, "post-recovery")
                assert status == 200
            finally:
                _stop_all(gws)
