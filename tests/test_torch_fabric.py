"""The port's serving fabric on the CPU: the scenarios of the JAX
package's fabric suite, run on the port's gateway, workers, registry and
chaos injectors alone.

The fabric invariant: an ACCEPTED request (non-503) is never dropped — it
completes on some worker or fails within its own deadline — under:

* worker kill mid-load (crash, no drain, no farewell),
* heartbeat partition (control plane dies, data plane lives): eviction frees
  routing state and a healed partition rejoins cleanly,
* kill-mid-swap at every stage: any pre-flip death rolls back with the old
  version never missing a request; a post-flip death leaves the new version
  serving — either side of the flip is consistent,
* corrupted-checkpoint swap: the digest mismatch aborts the swap, old
  version still serving.

Plus the membership primitive, bucket-aware routing (prefer the replica
whose captured graphs cover the batch bucket; degrade — never fail — on
stale info), the worker heartbeat agent, the queue-depth autoscaling
supervisor and the address exchange's IPv4 contract. Every wait polls a condition with a deadline
(``torch_fabric.wait_for``); every server and gateway stops in a
``finally`` or a ``with``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import pytest

from synapseml_tpu_torch.core import (CheckpointStore, Membership, Table,
                                reset_failure_counts)
from synapseml_tpu_torch.io.distributed_serving import (DistributedServingServer,
                                                  FabricSupervisor,
                                                  ServingGateway, WorkerAgent)
from synapseml_tpu_torch.io.serving import ModelRegistry, ServingServer, SwapError
from synapseml_tpu_torch.testing.chaos import (ChaosSwap, FaultInjected,
                                         FlakyHTTPServer,
                                         chaos_heartbeat_partition,
                                         kill_worker)

from torch_fabric import echo as _echo, post as _post, wait_for


@pytest.fixture(autouse=True)
def _clean_counters():
    reset_failure_counts()
    yield


def _load(url, n, value="x", workers=4, timeout=10.0):
    """Fire n concurrent POSTs; returns (results, dropped). A request that
    got ANY definite status is in results; one that raised (hung socket,
    reset with no reply) is a DROP — the thing the fabric invariant
    forbids for accepted requests."""
    results, dropped = [], []
    lock = threading.Lock()

    def one(i):
        try:
            r = _post(url, value, timeout=timeout)
            with lock:
                results.append(r)
        except Exception as e:  # noqa: BLE001
            with lock:
                dropped.append((i, repr(e)))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, dropped


def _assert_fabric_invariant(results, dropped):
    assert not dropped, f"accepted requests dropped: {dropped}"
    bad = [s for s, _, _ in results if s not in (200, 503, 504)]
    assert not bad, f"unexpected statuses: {bad}"


# --------------------------------------------------------------------------
# membership primitive
# --------------------------------------------------------------------------

class TestMembership:
    def test_join_expire_evict_rejoin(self):
        t = [0.0]
        m = Membership(timeout=1.0, clock=lambda: t[0])
        assert m.beat("w1") == "join"
        assert m.beat("w1") is None           # keep-alive, not a join
        assert m.alive("w1")
        t[0] = 0.9
        assert m.expired() == []
        t[0] = 2.1
        assert m.expired() == ["w1"]
        assert m.evict("w1") and not m.alive("w1")
        assert m.evict("w1") is False         # idempotent
        assert m.beat("w1") == "rejoin"       # clean rejoin
        assert m.alive("w1")
        assert (m.joins, m.rejoins, m.evictions) == (1, 1, 1)

    def test_static_members_never_expire_until_upgraded(self):
        t = [0.0]
        m = Membership(timeout=1.0, clock=lambda: t[0])
        m.beat("w1", static=True)
        t[0] = 100.0
        assert m.expired() == [] and m.alive("w1")
        # first real heartbeat upgrades to dynamic: silence now matters
        m.beat("w1")
        t[0] = 102.0
        assert m.expired() == ["w1"]

    def test_rejoin_racing_lazy_eviction_keeps_membership(self):
        # the expired()+evict() two-step has a gap: a member whose rejoin
        # beat lands between the read and the act must NOT be evicted —
        # evict_if_expired re-checks staleness under the lock
        t = [0.0]
        m = Membership(timeout=1.0, clock=lambda: t[0])
        m.beat("w1")
        t[0] = 2.5
        assert m.expired() == ["w1"]          # sweep candidate captured
        m.beat("w1")                          # rejoin races, same tick
        assert m.evict_if_expired("w1") is False
        assert m.alive("w1") and m.evictions == 0
        # a member still genuinely overdue evicts as before
        t[0] = 5.0
        assert m.expired() == ["w1"]
        assert m.evict_if_expired("w1") is True
        assert not m.alive("w1") and m.evictions == 1
        # the unconditional evict (voluntary deregister) ignores freshness
        assert m.beat("w1") == "rejoin"
        assert m.evict("w1") is True

    def test_evict_if_expired_skips_static_and_absent(self):
        t = [0.0]
        m = Membership(timeout=1.0, clock=lambda: t[0])
        m.beat("static", static=True)
        t[0] = 100.0
        assert m.evict_if_expired("static") is False   # static never lazy
        assert m.evict_if_expired("ghost") is False    # unknown member
        assert m.alive("static")

    def test_snapshot_carries_info_and_counters(self):
        t = [0.0]
        m = Membership(timeout=5.0, clock=lambda: t[0])
        m.beat("w1", queue_depth=3, version="v1")
        t[0] = 2.0
        snap = m.snapshot()
        assert snap["members"]["w1"]["age_s"] == pytest.approx(2.0)
        assert m.info("w1")["queue_depth"] == 3
        assert snap["joins"] == 1 and snap["timeout_s"] == 5.0


# --------------------------------------------------------------------------
# gateway membership: join / evict / rejoin over the control plane
# --------------------------------------------------------------------------

class TestGatewayMembership:
    def test_heartbeat_join_evict_on_silence_then_rejoin(self):
        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w1, \
                ServingServer(_echo, port=0, max_batch_latency=0.0) as w2:
            gw = ServingGateway([f"http://{w1.host}:{w1.port}"],
                                heartbeat_timeout=0.4).start()
            try:
                agent = WorkerAgent(w2, f"http://{gw.host}:{gw.port}",
                                    interval=0.1)
                agent.start()
                wait_for(lambda: len(gw.links) == 2, what="the join")
                assert gw.stats["joined"] == 1
                # partition the control plane only: beats drop, eviction
                # follows, yet the DATA path to w2 stays perfectly healthy
                with chaos_heartbeat_partition() as part:
                    wait_for(lambda: (gw._sweep_expired(),
                                      len(gw.links) == 1)[1],
                             what="the eviction")
                    assert gw.stats["evicted"] == 1
                    assert part.dropped, "partition never dropped a beat"
                    assert _post(w2.url, "direct")[0] == 200
                    # gateway traffic routes to the survivor: nothing fails
                    results, dropped = _load(gw.url, 8)
                    _assert_fabric_invariant(results, dropped)
                    assert all(s == 200 for s, _, _ in results)
                # healed: the next beat rejoins with a fresh link
                wait_for(lambda: len(gw.links) == 2, what="the rejoin")
                assert gw.stats["rejoined"] == 1
                agent.stop()
                # clean deregister leave
                wait_for(lambda: len(gw.links) == 1, what="the leave")
                assert gw.stats["deregistered"] == 1
            finally:
                gw.stop()

    def test_rejoin_racing_gateway_sweep_keeps_link_and_affinity(self):
        # gateway-level twin of the Membership race: a worker whose
        # heartbeat lands between the sweep's expired() read and the evict
        # keeps its link AND its shape-affinity pins
        t = [0.0]
        gw = ServingGateway(["http://127.0.0.1:9"],   # static placeholder
                            heartbeat_timeout=1.0, clock=lambda: t[0])
        url = "http://127.0.0.1:19999"
        gw.register_worker(url, queue_depth=0)        # dynamic member
        gw._pin_affinity(("s", (4, 2)), url)
        t[0] = 2.5
        assert gw.membership.expired() == [url]       # sweep candidate
        gw.register_worker(url, queue_depth=1)        # rejoin, same tick
        assert gw._evict(url, reason="evicted",
                         only_if_expired=True) is False
        assert any(l.url == url for l in gw.links)
        assert gw._affinity.get(("s", (4, 2))) == url
        assert gw.stats["evicted"] == 0
        # genuinely overdue: the sweep evicts and drops the affinity pin
        t[0] = 5.0
        gw._sweep_expired()
        assert not any(l.url == url for l in gw.links)
        assert ("s", (4, 2)) not in gw._affinity
        assert gw.stats["evicted"] == 1

    def test_static_workers_without_heartbeats_are_never_evicted(self):
        t = [0.0]
        with FlakyHTTPServer() as backend:
            gw = ServingGateway([backend.url], heartbeat_timeout=0.1,
                                clock=lambda: t[0]).start()
            try:
                t[0] = 0.3          # three heartbeat timeouts of silence
                gw._sweep_expired()
                assert len(gw.links) == 1          # legacy fixed-list mode
                assert _post(gw.url, "x")[0] == 200
            finally:
                gw.stop()

    def test_health_surfaces_membership_and_breaker_state(self):
        with FlakyHTTPServer(script=["reset"] * 3) as flaky:
            gw = ServingGateway([flaky.url], cooldown=30.0,
                                breaker_threshold=3).start()
            try:
                for _ in range(3):
                    _post(gw.url, "x")
                with urllib.request.urlopen(gw.url, timeout=5) as r:
                    health = json.loads(r.read().decode())
                assert health["workers"][0]["state"] == "open"
                member = health["membership"]["members"][flaky.url]
                assert member["static"] is True
                for key in ("forwarded", "retried", "failed", "heartbeats",
                            "joined", "evicted", "rejoined"):
                    assert key in health
            finally:
                gw.stop()

    def test_worker_agent_advertises_buckets_and_version(self):
        class _Runner:
            def warm_buckets(self):
                return [1, 8, 16]

        def handler(df):
            return _echo(df)

        handler.runner = _Runner()
        with ServingServer(handler, port=0, max_batch_latency=0.0) as w:
            ModelRegistry(w, version="m@1")
            agent = WorkerAgent(w, "http://127.0.0.1:1", worker_id="wid-1")
            p = agent.payload()
            assert p["id"] == "wid-1"
            assert p["warm_buckets"] == [1, 8, 16]
            assert p["version"] == "m@1"
            assert p["queue_depth"] == 0


# --------------------------------------------------------------------------
# bucket-aware routing
# --------------------------------------------------------------------------

class TestBucketRouting:
    def test_prefers_replica_with_warm_bucket(self):
        with FlakyHTTPServer() as cold, FlakyHTTPServer() as warm:
            gw = ServingGateway([cold.url, warm.url]).start()
            try:
                gw.register_worker(warm.url, warm_buckets=[16])
                batch = {"x": [[1.0, 2.0]] * 8}   # 8 rows -> bucket <= 16
                for _ in range(6):
                    assert _post(gw.url, batch)[0] == 200
                assert warm.requests == 6 and cold.requests == 0
            finally:
                gw.stop()

    def test_stale_or_missing_bucket_info_degrades_to_least_loaded(self):
        with FlakyHTTPServer() as a, FlakyHTTPServer() as b:
            gw = ServingGateway([a.url, b.url]).start()
            try:
                # garbage advertisement must not break routing
                gw.register_worker(b.url, warm_buckets="not-a-ladder")
                # un-parseable body -> no hint -> plain least-loaded
                for i in range(8):
                    assert _post(gw.url, [1, 2, 3])[0] == 200
                assert a.requests + b.requests == 8
            finally:
                gw.stop()

    def test_rows_header_hint_routes_without_body_parse(self):
        with FlakyHTTPServer() as cold, FlakyHTTPServer() as warm:
            gw = ServingGateway([cold.url, warm.url]).start()
            try:
                gw.register_worker(warm.url, warm_buckets=[32])
                for _ in range(4):
                    status, _, _ = _post(gw.url, "opaque",
                                         headers={"X-Batch-Rows": "20"})
                    assert status == 200
                assert warm.requests == 4 and cold.requests == 0
            finally:
                gw.stop()

    def test_same_shape_traffic_is_sticky(self):
        with FlakyHTTPServer() as a, FlakyHTTPServer() as b:
            gw = ServingGateway([a.url, b.url]).start()
            try:
                batch = {"x": [[1.0] * 4] * 2}
                for _ in range(10):
                    assert _post(gw.url, batch)[0] == 200
                # affinity pins one replica; the other sees nothing
                assert sorted([a.requests, b.requests]) == [0, 10]
            finally:
                gw.stop()


# --------------------------------------------------------------------------
# fabric invariant under chaos
# --------------------------------------------------------------------------

class TestFabricInvariant:
    def test_worker_kill_mid_load_never_drops_accepted_requests(self):
        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w1:
            w2 = ServingServer(_echo, port=0, max_batch_latency=0.0).start()
            gw = ServingGateway(
                [f"http://{w1.host}:{w1.port}",
                 f"http://{w2.host}:{w2.port}"],
                forward_timeout=2.0, breaker_threshold=1,
                cooldown=30.0).start()
            try:
                results, dropped = _load(gw.url, 10)
                _assert_fabric_invariant(results, dropped)
                kill_worker(w2)               # crash: no drain, no farewell
                results, dropped = _load(gw.url, 20)
                _assert_fabric_invariant(results, dropped)
                # sibling retry masked the crash completely
                assert all(s == 200 for s, _, _ in results)
                assert gw.stats["failed"] == 0
            finally:
                gw.stop()
                w2.stop(drain=False)

    def test_killed_worker_is_evicted_then_rejoins_on_restart(self):
        with ServingServer(_echo, port=0, max_batch_latency=0.0) as w1:
            w2 = ServingServer(_echo, port=0, max_batch_latency=0.0).start()
            gw = ServingGateway([f"http://{w1.host}:{w1.port}"],
                                heartbeat_timeout=0.4,
                                breaker_threshold=1, cooldown=30.0).start()
            agent = WorkerAgent(w2, f"http://{gw.host}:{gw.port}",
                                interval=0.1)
            try:
                agent.start()
                wait_for(lambda: len(gw.links) == 2, what="the join")
                kill_worker(w2)
                agent.stop(deregister=False)   # the whole process died
                wait_for(lambda: (gw._sweep_expired(),
                                  len(gw.links) == 1)[1],
                         what="the eviction")
                assert gw.stats["evicted"] == 1
                results, dropped = _load(gw.url, 10)
                _assert_fabric_invariant(results, dropped)
                assert all(s == 200 for s, _, _ in results)
                # "restart" the worker: a new server + agent rejoins cleanly
                w3 = ServingServer(_echo, port=0,
                                   max_batch_latency=0.0).start()
                agent2 = WorkerAgent(
                    w3, f"http://{gw.host}:{gw.port}", interval=0.1)
                agent2.start()
                try:
                    wait_for(lambda: len(gw.links) == 2, what="the rejoin")
                    results, dropped = _load(gw.url, 10)
                    _assert_fabric_invariant(results, dropped)
                    assert all(s == 200 for s, _, _ in results)
                finally:
                    agent2.stop()
                    w3.stop()
            finally:
                gw.stop()
                w2.stop(drain=False)


# --------------------------------------------------------------------------
# zero-downtime hot-swap
# --------------------------------------------------------------------------

def _mk_handler(scale):
    def handler(df: Table) -> Table:
        vals = [v * scale if isinstance(v, (int, float)) else v
                for v in df["value"]]
        import numpy as np
        return Table({"id": df["id"],
                      "reply": np.array(vals, dtype=object)})
    return handler


class _SlowWarmHandler:
    """v2 handler whose warmup takes long enough for load to overlap it."""

    def __init__(self, scale, warm_s=0.3):
        self._inner = _mk_handler(scale)
        self.warm_s = warm_s
        self.warmed = threading.Event()

    def warmup(self):
        time.sleep(self.warm_s)         # simulated work: a slow capture
        self.warmed.set()

    def __call__(self, df):
        return self._inner(df)


class TestHotSwap:
    def test_swap_under_load_zero_5xx_and_bit_identical_old_responses(self):
        with ServingServer(_mk_handler(1), port=0, max_batch_size=8,
                           max_batch_latency=0.0) as server:
            reg = ModelRegistry(server, version="v1")
            pre = _post(server.url, 21)
            assert pre[0] == 200 and pre[1] == 21
            v2 = _SlowWarmHandler(100, warm_s=0.4)
            statuses, bodies = [], []
            lock = threading.Lock()
            stop = threading.Event()

            def hammer():
                while not stop.is_set():
                    s, b, _ = _post(server.url, 21, timeout=5.0)
                    with lock:
                        statuses.append(s)
                        bodies.append(b)

            threads = [threading.Thread(target=hammer) for _ in range(3)]
            for t in threads:
                t.start()
            wait_for(lambda: len(statuses) >= 3, what="the hammer's replies")
            # during warmup the OLD version serves, bit-identical
            during = _post(server.url, 21)
            swap_t = threading.Thread(
                target=reg.swap_to, args=("v2", v2))
            swap_t.start()
            while not v2.warmed.is_set():
                mid = _post(server.url, 21)
                assert mid[0] == 200
            swap_t.join()
            n = len(statuses)
            wait_for(lambda: len(statuses) >= n + 3,
                     what="replies after the flip")
            stop.set()
            for t in threads:
                t.join()
            assert during[0] == 200 and during[1] == pre[1] == 21
            # fabric acceptance: zero 5xx for accepted requests, and every
            # response is a committed version's output — never a mix
            assert statuses and all(s == 200 for s in statuses)
            assert set(bodies) <= {21, 2100}
            assert 2100 in bodies          # the flip actually happened
            post = _post(server.url, 21)
            assert post[1] == 2100 and reg.active == "v2"
            assert reg.snapshot()["swaps"] == 1

    def test_requests_pin_admission_version_across_flip(self):
        release = threading.Event()
        admitted = threading.Event()

        def v1(df):
            admitted.set()
            release.wait(5.0)
            return _mk_handler(1)(df)

        with ServingServer(v1, port=0, max_batch_size=4,
                           max_batch_latency=0.0) as server:
            reg = ModelRegistry(server, version="v1")
            got = {}

            def fire():
                got["r"] = _post(server.url, 7, timeout=10.0)

            t = threading.Thread(target=fire)
            t.start()
            assert admitted.wait(5.0)
            # the in-flight request was admitted under v1; flip to v2 now
            reg.swap_to("v2", _mk_handler(1000), warmup=False)
            release.set()
            t.join()
            # pinned: it completed on v1's program (7), not v2's (7000)
            assert got["r"][0] == 200 and got["r"][1] == 7
            assert _post(server.url, 7)[1] == 7000

    def test_kill_mid_swap_pre_flip_rolls_back_old_never_stops(self):
        with ServingServer(_mk_handler(1), port=0, max_batch_size=8,
                           max_batch_latency=0.0) as server:
            reg = ModelRegistry(server, version="v1")
            for stage in ("build", "warmup"):
                with ChaosSwap(at=stage) as chaos:
                    with pytest.raises(SwapError):
                        reg.swap_to(f"v2-{stage}", _SlowWarmHandler(
                            100, warm_s=0.0))
                    assert chaos.kills, f"no kill injected at {stage}"
                assert reg.active == "v1"
                assert _post(server.url, 3)[1] == 3   # old never stopped
            assert reg.swap_failures == 2
            assert reg.snapshot()["versions"] == ["v1"]

    def test_kill_after_flip_leaves_new_version_serving(self):
        with ServingServer(_mk_handler(1), port=0, max_batch_size=8,
                           max_batch_latency=0.0) as server:
            reg = ModelRegistry(server, version="v1")
            with ChaosSwap(at="done"):
                with pytest.raises(FaultInjected):
                    reg.swap_to("v2", _mk_handler(100), warmup=False)
            # the flip happened before the kill: new version is consistent
            assert reg.active == "v2"
            assert _post(server.url, 5)[1] == 500

    def test_corrupted_checkpoint_swap_rolls_back(self, tmp_path):
        from synapseml_tpu_torch.testing.chaos import bit_flip

        store = CheckpointStore(str(tmp_path))
        store.save(1, {"weights": b"x" * 64})
        with ServingServer(_mk_handler(1), port=0, max_batch_size=8,
                           max_batch_latency=0.0) as server:
            reg = ModelRegistry(server, version="v1")
            bit_flip(str(tmp_path))            # storage rot: digest mismatch
            with pytest.raises(SwapError):
                reg.swap_from_store(
                    store, lambda ck: _mk_handler(100))
            assert reg.active == "v1"
            assert reg.swap_failures == 1
            assert _post(server.url, 9)[1] == 9

    def test_swap_from_store_uses_digest_versioning(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        store.save(1, {"weights": b"\x01\x02"})
        with ServingServer(_mk_handler(1), port=0, max_batch_size=8,
                           max_batch_latency=0.0) as server:
            reg = ModelRegistry(server, version="v1")
            built = {}

            def builder(ck):
                built["ckpt"] = ck
                return _mk_handler(10)

            version = reg.swap_from_store(store, builder)
            assert reg.active == version and "@" in version
            assert built["ckpt"].artifacts["weights"] == b"\x01\x02"
            assert _post(server.url, 4)[1] == 40
            # idempotent: same bytes -> same version -> no second swap
            assert reg.swap_from_store(store, builder) == version
            assert reg.swaps == 1

    def test_kill_mid_swap_under_gateway_load(self):
        """The combined chaos case the CI fabric step runs: swap dies at
        warmup while the gateway is forwarding — no accepted request is
        dropped, none sees a 5xx, the old version keeps serving."""
        with ServingServer(_mk_handler(1), port=0, max_batch_size=8,
                           max_batch_latency=0.0) as server:
            reg = ModelRegistry(server, version="v1")
            gw = ServingGateway(
                [f"http://{server.host}:{server.port}"],
                forward_timeout=5.0).start()
            try:
                with ChaosSwap(at="warmup") as chaos:
                    fail = {}

                    def doomed_swap():
                        try:
                            reg.swap_to("v2", _SlowWarmHandler(100))
                        except SwapError as e:
                            fail["err"] = e

                    t = threading.Thread(target=doomed_swap)
                    t.start()
                    results, dropped = _load(gw.url, 20, value=11)
                    t.join()
                    _assert_fabric_invariant(results, dropped)
                    assert all(s == 200 for s, _, _ in results)
                    assert all(b == 11 for _, b, _ in results)
                    assert "err" in fail and chaos.kills
                assert reg.active == "v1"
            finally:
                gw.stop()


# --------------------------------------------------------------------------
# autoscaling supervisor
# --------------------------------------------------------------------------

class TestFabricSupervisor:
    def test_decide_is_pure_hysteresis(self):
        sup = FabricSupervisor(gateway=None.__class__ and _FakeGW(),
                               spawn_fn=lambda: None,
                               retire_fn=lambda u: None,
                               min_workers=1, max_workers=4,
                               scale_up_depth=4.0, scale_down_depth=0.5)
        assert sup.decide(0, 0.0) == "up"          # below the floor
        assert sup.decide(2, 8.0) == "up"          # hot queue
        assert sup.decide(4, 8.0) is None          # at the ceiling
        assert sup.decide(2, 0.1) == "down"        # idle
        assert sup.decide(1, 0.0) is None          # at the floor
        assert sup.decide(2, 2.0) is None          # hysteresis band

    def test_step_spawns_and_retires_from_queue_depth(self):
        with FlakyHTTPServer() as a, FlakyHTTPServer() as b:
            gw = ServingGateway([a.url, b.url]).start()
            try:
                actions = {"spawned": 0, "retired": []}
                sup = FabricSupervisor(
                    gw, spawn_fn=lambda: actions.__setitem__(
                        "spawned", actions["spawned"] + 1),
                    retire_fn=lambda url: actions["retired"].append(url),
                    min_workers=1, max_workers=4,
                    scale_up_depth=4.0, scale_down_depth=0.5)
                gw.register_worker(a.url, queue_depth=10)
                gw.register_worker(b.url, queue_depth=10)
                assert sup.step() == "up" and actions["spawned"] == 1
                gw.register_worker(a.url, queue_depth=0)
                gw.register_worker(b.url, queue_depth=0)
                assert sup.step() == "down"
                assert actions["retired"] and \
                    actions["retired"][0] in (a.url, b.url)
            finally:
                gw.stop()

    def test_invalid_thresholds_rejected(self):
        with pytest.raises(ValueError):
            FabricSupervisor(_FakeGW(), spawn_fn=lambda: None,
                             scale_up_depth=1.0, scale_down_depth=2.0)
        with pytest.raises(ValueError):
            FabricSupervisor(_FakeGW(), spawn_fn=lambda: None,
                             min_workers=0)


class _FakeGW:
    links: list = []
    _lock = threading.Lock()
    _local_link = None


# --------------------------------------------------------------------------
# address-exchange constraint (satellite)
# --------------------------------------------------------------------------

class TestAddrExchange:
    @pytest.mark.parametrize("bad", ["fe80::1", "worker-0.svc.cluster.local"])
    def test_non_ipv4_advertise_host_raises_clearly(self, monkeypatch, bad):
        from synapseml_tpu_torch.io import distributed_serving as ds

        dss = DistributedServingServer(_echo, advertise_host=bad)
        monkeypatch.setattr(ds, "process_count", lambda: 2)
        with pytest.raises(ValueError, match="IPv4"):
            dss._gather_worker_addrs(8080)

    def test_single_process_skips_exchange(self):
        dss = DistributedServingServer(_echo)
        assert dss._gather_worker_addrs(1234) == ["http://127.0.0.1:1234"]

