"""The port's multi-tenant serving fleet on the CPU: the scenarios of the
JAX package's multitenant suite, run on the port alone.

The multi-tenant isolation invariant: K=3 tenants from three model
families (the port's gbdt forest, a torch net behind a ``BucketedRunner``,
the port's vw policy) share M=2 workers, one gateway, and one QoS layer —
and flooding, NaN-storming, or killing ONE tenant's traffic/model never
5xxs another tenant's accepted requests. Plus the fleet mechanics
underneath:

* per-tenant token-bucket admission (429) and quarantine breakers (503),
  weighted-fair dequeue across tenant lanes,
* the explicit `Membership.evict_stale()` sweep + `fabric.evicted_idle`,
* the swap lock: two racing promoters, one deterministic loser,
* per-tenant swap pinning: a request admitted under (tenant, v0) is
  answered by v0 even if the flip lands mid-flight; swapping tenant A
  never touches tenant B,
* shared-runner accounting: one runner fleet, per-tenant capture/hit
  counters, fleet totals,
* kill-mid-promotion-broadcast: two-phase prepare/commit leaves every
  worker on ONE gate-approved version (forward or rolled back), and the
  online loop's gate approval driving the broadcast.

Everything is scripted, seeded, or fake-clocked — reruns see the same
fault sequence; waits poll a condition with a deadline.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.core import Membership, Table, reset_failure_counts
from synapseml_tpu_torch.core.inference import BucketedRunner, RunnerFleet
from synapseml_tpu_torch.core.logging import failure_counts
from synapseml_tpu_torch.core.qos import (QoSClass, QoSController,
                                          WeightedFairQueue)
from synapseml_tpu_torch.io.distributed_serving import (BroadcastError,
                                                        PromotionBroadcast,
                                                        ServingGateway,
                                                        WorkerAgent)
from synapseml_tpu_torch.io.serving import (ModelRegistry, ServingServer,
                                            SwapError, _PendingRequest)
from synapseml_tpu_torch.testing import chaos_tenant_flood

from torch_fabric import post as _post, wait_for
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_counters():
    reset_failure_counts()
    yield


# --------------------------------------------------------------------------
# tenant handler fixtures: three real model families, sized for CI
# --------------------------------------------------------------------------

def _gbdt_handler():
    """Tiny REAL trained forest behind the bucketed serving path."""
    from synapseml_tpu_torch.gbdt import BoosterConfig, Dataset, train_booster

    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 8)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] > 0).astype(np.float32)
    booster = train_booster(
        Dataset(X, y, device=CPU), None,
        BoosterConfig(objective="binary", num_iterations=5, num_leaves=7),
        device=CPU)
    predict = booster.serving_fn(max_batch_size=8)

    def handler(df: Table) -> Table:
        x = np.asarray([v["x"] for v in df["value"]], np.float32)
        out = np.asarray(predict(x))
        return Table({"id": df["id"], "reply": out.astype(np.float64)})

    handler.warmup = predict.warmup
    handler.runner = predict.runner
    return handler


def _dl_handler():
    """Small dense net through a BucketedRunner (the dl serving shape)."""
    rng = np.random.default_rng(1)
    W = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))

    def net(x):
        return torch.tanh(x @ W).sum(dim=-1)

    runner = BucketedRunner(net, max_batch_size=8, growth=8.0,
                            name="mt.dl", device=CPU)

    def handler(df: Table) -> Table:
        x = np.asarray([v["x"] for v in df["value"]], np.float32)
        out = np.asarray(runner(x))
        return Table({"id": df["id"], "reply": out.astype(np.float64)})

    handler.warmup = lambda: runner.warmup(np.zeros((1, 8), np.float32))
    handler.runner = runner
    return handler


def _vw_handler(version="v0"):
    """Frozen epsilon-greedy policy handler (the vw/online family)."""
    from synapseml_tpu_torch.online import GreedyPolicy, make_policy_handler
    from synapseml_tpu_torch.vw.learner import VWConfig, VWState, make_sparse_batch

    cfg = VWConfig(num_bits=10, batch_size=8, learning_rate=0.5)

    def featurize(_v=None):
        return list(make_sparse_batch(
            [[a * 7 + 1, a * 7 + 2] for a in range(3)],
            [[1.0, 1.0]] * 3, pad_to=4))

    policy = GreedyPolicy(VWState.init(cfg.num_bits, CPU), cfg, epsilon=1.0,
                          seed=0, version=version)
    return make_policy_handler(policy, featurize)


_X8 = {"x": [0.1] * 8}       # payload both gbdt and dl handlers accept


def _scaled(factory, scale):
    """Distinct handler object computing ``scale * base`` — cheap distinct
    versions for swap/broadcast tests."""
    base = factory()

    def handler(df: Table) -> Table:
        out = base(df)
        return Table({"id": out["id"],
                      "reply": np.asarray(out["reply"], np.float64) * scale})

    return handler


# --------------------------------------------------------------------------
# core/qos.py primitives (fake clock — no sleeps)
# --------------------------------------------------------------------------

class TestQoSPrimitives:
    def test_token_bucket_sheds_then_refills(self):
        t = [0.0]
        q = QoSController(default_class=QoSClass(rate_per_sec=10.0,
                                                 burst=2.0),
                          clock=lambda: t[0])
        assert q.admit("a").ok and q.admit("a").ok
        d = q.admit("a")
        assert (d.ok, d.status, d.reason) == (False, 429, "rate_limited")
        t[0] = 0.5                       # 10/s * 0.5s = 5 tokens back
        assert q.admit("a").ok

    def test_quarantine_opens_and_cools_down(self):
        t = [0.0]
        q = QoSController(default_class=QoSClass(
            quarantine_threshold=2, quarantine_cooldown=1.0),
            clock=lambda: t[0])
        q.record_failure("bad", n=2, nonfinite=True)
        d = q.admit("bad")
        assert (d.status, d.reason) == (503, "quarantined")
        assert q.is_quarantined("bad")
        assert q.admit("good").ok        # isolation: other tenants admitted
        t[0] = 1.5                       # cooldown: half-open probe admitted
        assert q.admit("bad").ok

    def test_weighted_fair_dequeue_ratio(self):
        q = QoSController(
            default_class=QoSClass(),
            classes={"heavy": QoSClass(weight=2.0)})
        wfq = WeightedFairQueue(maxsize=64, qos=q)
        for i in range(6):
            wfq.put_nowait(_PendingRequest(
                id=f"h{i}", method="POST", path="/", headers={}, body=b"",
                tenant="heavy"))
            wfq.put_nowait(_PendingRequest(
                id=f"l{i}", method="POST", path="/", headers={}, body=b"",
                tenant="light"))
        order = [wfq.get_nowait().tenant for _ in range(6)]
        # weight 2 tenant drains twice as fast: 2 heavy per light
        assert order.count("heavy") == 4 and order.count("light") == 2

    def test_lane_cap_isolates_queue_flood(self):
        import queue as _q
        q = QoSController(default_class=QoSClass(max_queue=2))
        wfq = WeightedFairQueue(maxsize=64, qos=q)
        mk = lambda i, t: _PendingRequest(   # noqa: E731
            id=f"{t}{i}", method="POST", path="/", headers={}, body=b"",
            tenant=t)
        wfq.put_nowait(mk(0, "flood"))
        wfq.put_nowait(mk(1, "flood"))
        with pytest.raises(_q.Full):
            wfq.put_nowait(mk(2, "flood"))   # flood's lane full…
        wfq.put_nowait(mk(0, "calm"))        # …calm's lane unaffected
        assert wfq.lane_depth("flood") == 2 and wfq.lane_depth("calm") == 1


# --------------------------------------------------------------------------
# satellite: explicit eviction sweep
# --------------------------------------------------------------------------

class TestEvictStaleSweep:
    def test_sweep_evicts_counts_and_is_idempotent(self):
        t = [0.0]
        m = Membership(timeout=1.0, clock=lambda: t[0])
        m.beat("w1")
        m.beat("w2")
        m.beat("static", static=True)
        t[0] = 5.0
        assert sorted(m.evict_stale()) == ["w1", "w2"]
        assert failure_counts().get("fabric.evicted_idle") == 2
        assert m.evict_stale() == []          # second sweep: nothing left
        assert m.alive("static")              # static members never swept
        assert not m.alive("w1") and not m.alive("w2")


# --------------------------------------------------------------------------
# satellite: concurrent swap race — one deterministic loser
# --------------------------------------------------------------------------

class TestSwapRace:
    def test_two_promoters_one_loser(self):
        from synapseml_tpu_torch.io import serving as sv

        srv = ServingServer(lambda df: df.with_column("reply", df["value"]),
                            port=0, warmup=False)
        reg = ModelRegistry(srv, version="v0")
        inside = threading.Event()
        release = threading.Event()
        first = [True]
        flock = threading.Lock()

        def hook(stage, version):
            # first swapper parks inside the critical section; the second
            # must then lose at the lock, not block
            if stage == "build":
                with flock:
                    me_first, first[0] = first[0], False
                if me_first:
                    inside.set()
                    release.wait(5.0)

        results = {}

        def promoter(name, version):
            try:
                results[name] = reg.swap_to(
                    version, lambda df: df.with_column(
                        "reply", df["value"]), warmup=False)
            except SwapError as e:
                results[name] = e

        sv._SWAP_HOOK = hook
        try:
            t1 = threading.Thread(target=promoter, args=("p1", "v1"))
            t1.start()
            assert inside.wait(5.0)
            t2 = threading.Thread(target=promoter, args=("p2", "v2"))
            t2.start()
            t2.join(5.0)                 # loser returns while winner parked
            release.set()
            t1.join(5.0)
        finally:
            sv._SWAP_HOOK = None
        assert results["p1"] == "v1"     # winner completed its flip
        assert isinstance(results["p2"], SwapError)
        assert "swap in progress" in str(results["p2"])
        assert reg.active == "v1"
        assert failure_counts().get("serving.swap_conflict", 0) >= 1

    def test_prepare_blocks_racing_swap_until_commit(self):
        srv = ServingServer(lambda df: df, port=0, warmup=False)
        reg = ModelRegistry(srv, version="v0")
        reg.prepare("v1", lambda df: df, warmup=False)
        with pytest.raises(SwapError, match="swap in progress"):
            reg.swap_to("v9", lambda df: df, warmup=False)
        assert reg.commit() == "v1"
        reg.swap_to("v2", lambda df: df, warmup=False)   # lock released
        assert reg.active == "v2"


# --------------------------------------------------------------------------
# per-tenant swap pinning
# --------------------------------------------------------------------------

class TestTenantSwapPinning:
    def test_admitted_requests_ride_their_pinned_version(self):
        srv = ServingServer(handler=None, port=0, warmup=False)
        reg_a = srv.add_tenant("a", _scaled(_dl_handler, 1.0), warmup=False)
        srv.add_tenant("b", _scaled(_dl_handler, 100.0), warmup=False)

        body = json.dumps(_X8).encode()
        pinned = _PendingRequest(id="r-old", method="POST", path="/",
                                 headers={}, body=body,
                                 handler=srv.handler_for("a"), tenant="a")
        # the flip lands while r-old sits in the queue…
        reg_a.swap_to("v1", _scaled(_dl_handler, -1.0), warmup=False)
        fresh = _PendingRequest(id="r-new", method="POST", path="/",
                                headers={}, body=body,
                                handler=srv.handler_for("a"), tenant="a")
        srv._run_batch([pinned, fresh])
        old = json.loads(pinned.response[2])
        new = json.loads(fresh.response[2])
        assert old == pytest.approx(-new)     # v0 answered the pinned one
        # tenant b's registry and handler never moved
        assert srv.registries["b"].active == "v0"
        assert json.loads(
            srv._call_handler([_PendingRequest(
                id="rb", method="POST", path="/", headers={}, body=body,
                tenant="b")], None, srv.handler_for("b"))["rb"][1]
        ) == pytest.approx(100.0 * old)


# --------------------------------------------------------------------------
# shared-compile-cache accounting
# --------------------------------------------------------------------------

class TestSharedFleetAccounting:
    def test_per_tenant_compile_hit_attribution(self):
        fleet = RunnerFleet()
        handlers = {"gbdt": _gbdt_handler(), "dl": _dl_handler()}
        for tenant, h in handlers.items():
            fleet.register(tenant, h.runner)
        assert fleet.tenants() == ["dl", "gbdt"]
        # warm the whole fleet off the hot path: compiles are paid up front
        x8 = np.zeros((1, 8), np.float32)
        stats = fleet.warm_all({"gbdt": (x8,), "dl": (x8,)})
        paid = stats["total_compiles"]
        assert paid >= 2                      # every tenant's ladder warmed
        # steady-state traffic is all hits, attributed to ITS tenant
        df = Table({"id": np.array(["1", "2"], dtype=object),
                    "value": np.array([_X8, _X8], dtype=object)})
        for _ in range(4):
            handlers["dl"](df)
        after = fleet.stats()
        assert after["total_compiles"] == paid            # zero recompiles
        assert after["tenants"]["dl"]["total_hits"] >= 4
        assert after["tenants"]["gbdt"]["total_hits"] == 0
        assert after["total_hits"] == sum(
            s["total_hits"] for s in after["tenants"].values())


# --------------------------------------------------------------------------
# the noisy-neighbor chaos invariant: K=3 tenants on M=2 workers
# --------------------------------------------------------------------------

def _tenant_post(url, tenant, value, timeout=10.0):
    return _post(url, value, headers={"X-Tenant": tenant}, timeout=timeout)


def _mk_fleet():
    """2 workers x 3 tenants (gbdt + dl + vw) + gateway + heartbeats.
    The flood tenant gets a rate-limited QoS class and a hair-trigger
    quarantine so the chaos battery finishes fast."""
    workers, agents = [], []
    for _ in range(2):
        qos = QoSController(
            default_class=QoSClass(),
            classes={"gbdt": QoSClass(rate_per_sec=200.0, burst=20.0,
                                      quarantine_threshold=3,
                                      quarantine_cooldown=5.0)})
        w = ServingServer(handler=None, port=0, qos=qos,
                          max_batch_latency=0.0, warmup=False)
        w.add_tenant("gbdt", _gbdt_handler(), warmup=False)
        w.add_tenant("dl", _dl_handler(), warmup=False)
        w.add_tenant("vw", _vw_handler(), warmup=False)
        workers.append(w.start())
    gw = ServingGateway([w.url for w in workers], port=0,
                        heartbeat_timeout=30.0).start()
    for i, w in enumerate(workers):
        a = WorkerAgent(w, f"http://{gw.host}:{gw.port}",
                        worker_id=f"mt-w{i}", interval=0.2)
        a.start()
        agents.append(a)
    # heartbeats advertise tenants
    wait_for(lambda: all(l.tenants for l in gw.links),
             what="the tenants' advertisements")
    return workers, agents, gw


def _teardown_fleet(workers, agents, gw):
    for a in agents:
        a.stop()
    gw.stop()
    for w in workers:
        w.stop()


class TestNoisyNeighborInvariant:
    def test_flooded_nan_storming_tenant_cannot_hurt_the_others(self):
        workers, agents, gw = _mk_fleet()
        url = f"http://{gw.host}:{gw.port}/"
        try:
            # heartbeats carry per-(tenant, model) versions + warm ladders
            for link in gw.links:
                assert set(link.tenants) == {"gbdt", "dl", "vw"}
                assert link.tenants["dl"]["version"] == "v0"

            # baseline: every tenant serves through the gateway
            for tenant in ("gbdt", "dl", "vw"):
                s, body, _ = _tenant_post(url, tenant, _X8)
                assert s == 200, (tenant, body)

            # chaos: tenant "gbdt" NaN-storms AND floods — sabotage both
            # workers (per-(server, tenant) wrap nests), flood the gateway
            with chaos_tenant_flood(url, "gbdt", server=workers[0],
                                    nan=True), \
                 chaos_tenant_flood(url, "gbdt", n_requests=120, threads=6,
                                    seed=3, server=workers[1],
                                    nan=True) as flood:
                flood.run()
                counts = flood.status_counts()
                # the abuser is shed at ITS OWN boundary: per-tenant 500
                # (non-finite guard), 429 (token bucket), 503 (quarantine /
                # gateway tenant breaker) — never a 200 of garbage
                assert set(counts) <= {429, 500, 503}, counts
                assert counts.get(503, 0) > 0    # quarantine engaged

                # …while the OTHER tenants' accepted requests never 5xx
                lat = {"dl": [], "vw": []}
                for _ in range(25):
                    for tenant in ("dl", "vw"):
                        s, body, el = _tenant_post(url, tenant, _X8)
                        assert s == 200, (tenant, s, body)
                        lat[tenant].append(el)
                for tenant, xs in lat.items():
                    p99 = sorted(xs)[int(len(xs) * 0.99)]
                    assert p99 < 2.0, (tenant, p99)

            # abuser's handler restored + quarantine cools: tenant recovers
            wait_for(lambda: _tenant_post(url, "gbdt", _X8)[0] == 200,
                     interval=0.25, what="the abuser's recovery")
        finally:
            _teardown_fleet(workers, agents, gw)


# --------------------------------------------------------------------------
# kill-mid-promotion-broadcast: no mixed-version fabric, ever
# --------------------------------------------------------------------------

def _mk_registries(n=2):
    regs = []
    servers = []
    for _ in range(n):
        srv = ServingServer(handler=None, port=0, warmup=False)
        regs.append(srv.add_tenant("vw", _vw_handler("v0"), warmup=False))
        servers.append(srv)
    return servers, regs


class _KillAt:
    """Manual _SWAP_HOOK killer (stage-targeted, bounded kill count)."""

    def __init__(self, stage, max_kills=1):
        self.stage, self.kills, self.max_kills = stage, 0, max_kills

    def __call__(self, stage, version):
        if stage == self.stage and self.kills < self.max_kills:
            self.kills += 1
            raise RuntimeError(f"chaos: killed broadcast at {stage}")


class TestPromotionBroadcast:
    def _with_hook(self, hook, fn):
        from synapseml_tpu_torch.io import serving as sv
        sv._SWAP_HOOK = hook
        try:
            return fn()
        finally:
            sv._SWAP_HOOK = None

    def test_clean_broadcast_converges_forward(self):
        _, regs = _mk_registries()
        pb = PromotionBroadcast(regs)
        assert pb.broadcast("v1", _vw_handler("v1"), warmup=False) == "v1"
        assert pb.active_versions() == ["v1", "v1"] and pb.converged()

    def test_kill_mid_commit_retries_forward(self):
        _, regs = _mk_registries()
        pb = PromotionBroadcast(regs, commit_retries=1)
        self._with_hook(
            _KillAt("commit", max_kills=1),
            lambda: pb.broadcast("v1", _vw_handler("v1"), warmup=False))
        assert pb.active_versions() == ["v1", "v1"] and pb.converged()

    def test_persistent_commit_failure_rolls_everyone_back(self):
        _, regs = _mk_registries()
        pb = PromotionBroadcast(regs, commit_retries=1)
        with pytest.raises(BroadcastError):
            self._with_hook(
                _KillAt("commit", max_kills=99),
                lambda: pb.broadcast("v1", _vw_handler("v1"),
                                     warmup=False))
        assert pb.active_versions() == ["v0", "v0"] and pb.converged()

    def test_kill_in_prepare_aborts_all_old_version_serves_on(self):
        _, regs = _mk_registries()
        pb = PromotionBroadcast(regs)
        with pytest.raises(BroadcastError, match="old version"):
            self._with_hook(
                _KillAt("prepare", max_kills=1),
                lambda: pb.broadcast("v1", _vw_handler("v1"),
                                     warmup=False))
        assert pb.active_versions() == ["v0", "v0"] and pb.converged()
        # the lock was released by abort: a later broadcast succeeds
        assert pb.broadcast("v2", _vw_handler("v2"), warmup=False) == "v2"
        assert pb.active_versions() == ["v2", "v2"]

    def test_gate_approval_drives_the_fabric(self):
        """One gate verdict flips EVERY worker; the served version is
        always gate-approved on both (the no-mixed-fabric acceptance)."""
        from synapseml_tpu_torch.online import PromotionGate

        _, regs = _mk_registries()
        pb = PromotionBroadcast(regs)
        gate = PromotionGate(regs[0], min_samples=2, broadcast=pb)
        approved = set(gate.approved_versions)
        for reg in regs:
            assert reg.active in approved
        pb.broadcast("v1", _vw_handler("v1"), warmup=False)
        gate.approved_versions.add("v1")
        assert pb.converged()
        assert all(r.active in gate.approved_versions for r in regs)
