"""The port's fabric decisions against the JAX package's, on the same
scripted inputs (CPU):

* ``GossipState`` merges and ``ConsistentHashRing`` placements on fake
  clocks: equal entries, epochs, owners, clocks and placements;
* the gateway's routing decisions — ``_shape_hint``,
  ``_bucket_aware_order`` and ``_pick`` over the same registered workers,
  advertised ladders, in-flight counts and breakers — and
  ``FabricSupervisor.decide``: equal;
* ``PromotionBroadcast``'s replicated phase records and its ``in_doubt`` /
  ``recover`` outcomes for the same scripted coordinator deaths: equal;
* replies through both packages' gateways over CPU workers for the same
  request script: equal statuses and bodies.

No fixed sleeps: gateways here are either never started or wait on
replies with a timeout; every server and gateway stops in a ``finally``
or a ``with``.
"""

from __future__ import annotations

import http.client
import json
import random

import numpy as np
import pytest

from synapseml_tpu.core import gossip as jgossip
from synapseml_tpu.core.table import Table as JTable
from synapseml_tpu.io import distributed_serving as jds
from synapseml_tpu.io import serving as jsv

from synapseml_tpu_torch.core import gossip as tgossip
from synapseml_tpu_torch.core.table import Table as TTable
from synapseml_tpu_torch.io import distributed_serving as tds
from synapseml_tpu_torch.io import serving as tsv

PACKAGES = {"jax": (jgossip, jds, jsv, JTable),
            "torch": (tgossip, tds, tsv, TTable)}


# ---------------------------------------------------------------------------
# gossip and the ring
# ---------------------------------------------------------------------------

def _gossip_script(gossip, seed: int):
    """Three nodes on one fake clock: a seeded script of publishes,
    retracts, pairwise merges and peer-clock observations. Returns every
    node's observable state after each step."""
    rng = random.Random(seed)
    t = [0.0]
    nodes = {n: gossip.GossipState(n, clock=lambda: t[0])
             for n in ("gw-a", "gw-b", "gw-c")}
    keys = [f"member/http://w{i}" for i in range(4)] + \
        ["gateway/gw-a", "lease/t1/gw-b", "promo/v2"]
    trace = []
    for step in range(120):
        t[0] += rng.random()
        op = rng.random()
        name = rng.choice(sorted(nodes))
        node = nodes[name]
        if op < 0.45:
            key = rng.choice(keys)
            node.publish(key, {"n": step, "by": name})
        elif op < 0.55:
            node.retract(rng.choice(keys))
        elif op < 0.9:
            other = nodes[rng.choice(sorted(set(nodes) - {name}))]
            accepted = node.merge(other.wire())
            node.observe_peer_clock(other.node_id, other.lamport)
            trace.append(("accepted", name,
                          sorted((e.key, e.epoch, e.origin)
                                 for e in accepted)))
        else:
            # concurrent same-epoch publishes: the origin id breaks the tie
            a, b = nodes["gw-a"], nodes["gw-b"]
            a.publish("tie", {"from": "a"})
            b.publish("tie", {"from": "b"})
            a.merge(b.wire())
            b.merge(a.wire())
        for n in sorted(nodes):
            g = nodes[n]
            trace.append((n, g.lamport, g.entries_behind(),
                          sorted(g.peer_clocks().items()),
                          sorted((e["key"], e["epoch"], e["origin"],
                                  json.dumps(e["value"], sort_keys=True))
                                 for e in g.wire()),
                          sorted((k, g.advanced_at(k)) for k in keys)))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gossip_merges_match_the_reference(seed):
    assert _gossip_script(tgossip, seed) == _gossip_script(jgossip, seed)


def test_gossip_snapshot_and_entry_wire_match_the_reference():
    out = {}
    for name, (gossip, *_rest) in PACKAGES.items():
        g = gossip.GossipState("gw-x", clock=lambda: 5.0)
        g.publish("member/a", {"q": 1})
        g.retract("member/a")
        g.publish("member/b", {"q": 2})
        e = gossip.GossipEntry.from_wire(g.entry("member/b").wire())
        out[name] = (g.snapshot(), e.wire(), g.items("member/"),
                     g.get("member/a"))
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("vnodes", [1, 16, 64])
def test_ring_placements_match_the_reference(vnodes):
    nodes = [f"http://127.0.0.1:{9000 + i}" for i in range(5)]
    keys = [f"tenant-{i}" for i in range(300)]
    got = {}
    for name, (gossip, *_rest) in PACKAGES.items():
        ring = gossip.ConsistentHashRing(nodes, vnodes=vnodes)
        before = [ring.node_for(k) for k in keys]
        ring.remove(nodes[2])
        after = [ring.node_for(k) for k in keys]
        excl = [ring.node_for(k, exclude=nodes[:2]) for k in keys]
        ring.add("http://127.0.0.1:9999")
        got[name] = (before, after, excl, [ring.node_for(k) for k in keys],
                     ring.nodes(), len(ring), nodes[3] in ring)
    assert got["torch"] == got["jax"]
    before, after = got["torch"][0], got["torch"][1]
    # only the removed node's arcs moved
    assert all(a == b for a, b in zip(before, after) if a != nodes[2])


# ---------------------------------------------------------------------------
# gateway routing decisions
# ---------------------------------------------------------------------------

WORKERS = [f"http://127.0.0.1:{19100 + i}" for i in range(4)]

HINT_BODIES = [
    (b'{"x": [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]}', None),
    (b'{"features": [0.1, 0.2, 0.3]}', None),
    (b'{"b": [], "a": [[1], [2]]}', None),
    (b'[1, 2, 3]', None),
    (b'"opaque"', None),
    (b'{"x": 1}', None),
    (b'{not json', None),
    (b'{"x": [' + b'1.0, ' * 2000 + b'1.0]}', None),
    (b'anything', {"X-Batch-Rows": "20"}),
    (b'anything', {"X-Batch-Rows": "0"}),
    (b'anything', {"X-Batch-Rows": "many"}),
    (b'', None),
]


def _gateway(ds, mode="least_loaded"):
    t = [0.0]
    gw = ds.ServingGateway(WORKERS[:2], mode=mode, heartbeat_timeout=5.0,
                           clock=lambda: t[0])
    gw.register_worker(WORKERS[1], warm_buckets=[16], queue_depth=3)
    gw.register_worker(WORKERS[2], warm_buckets=[1, 8, 64], queue_depth=0,
                       tenants={"a": {"version": "v1",
                                      "warm_buckets": [4]},
                                "b": {"version": "v2",
                                      "warm_buckets": [128]}})
    gw.register_worker(WORKERS[3], warm_buckets="not-a-ladder")
    return gw, t


def test_shape_hints_match_the_reference():
    hints = {}
    for name, (_g, ds, _sv, _T) in PACKAGES.items():
        gw, _ = _gateway(ds)
        hints[name] = [gw._shape_hint(b, h) for b, h in HINT_BODIES]
    assert hints["torch"] == hints["jax"]
    assert hints["torch"][0] == (3, ("x", 2))
    assert hints["torch"][8] == (20, None)


@pytest.mark.parametrize("mode", ["least_loaded", "round_robin"])
def test_pick_and_bucket_order_match_the_reference(mode):
    rng = np.random.default_rng(4)
    script = [(int(rng.integers(len(HINT_BODIES))),
               [None, "a", "b"][int(rng.integers(3))],
               rng.integers(0, 4, size=4).tolist(),
               bool(rng.random() < 0.15))
              for _ in range(60)]
    got = {}
    for name, (_g, ds, _sv, _T) in PACKAGES.items():
        gw, t = _gateway(ds, mode)
        trace = []
        for i, (b, tenant, inflight, fail) in enumerate(script):
            t[0] += 0.05
            body, headers = HINT_BODIES[b]
            hint = gw._shape_hint(body, headers)
            links = sorted(gw.links, key=lambda l: l.url)
            for link, n in zip(links, inflight):
                link.inflight = n
            order = [l.url for l in gw._bucket_aware_order(links, hint,
                                                          tenant)]
            link = gw._pick(set(), hint, tenant)
            if link is not None:
                # a transport failure trips the link's breaker; a success
                # releases a half-open probe
                link.mark_failed() if fail else link.mark_ok()
            trace.append((order, None if link is None else link.url,
                          sorted(gw._affinity.items(), key=repr)))
        got[name] = trace
    assert got["torch"] == got["jax"]


def test_supervisor_decisions_match_the_reference():
    grid = [(n, d) for n in range(0, 7) for d in
            (0.0, 0.2, 0.5, 1.0, 3.9, 4.0, 4.1, 9.0)]
    got = {}
    for name, (_g, ds, _sv, _T) in PACKAGES.items():
        gw, _ = _gateway(ds)
        out = []
        for retire in (None, lambda url: None):
            sup = ds.FabricSupervisor(gw, spawn_fn=lambda: None,
                                      retire_fn=retire, min_workers=2,
                                      max_workers=5, scale_up_depth=4.0,
                                      scale_down_depth=0.5)
            out.append([sup.decide(n, d) for n, d in grid])
            out.append(sup.observe())
        got[name] = out
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# the promotion broadcast's phase records and recovery
# ---------------------------------------------------------------------------

def _handler(scale):
    def h(df):
        return df
    h.scale = scale
    return h


def _broadcast_run(gossip, ds, sv, die_at):
    """Three registries over unstarted servers; a coordinator that dies
    before per-worker step ``die_at`` (None: never) broadcasts ``v2``; a
    survivor on the same replicated record then recovers the round."""
    control = gossip.GossipState("gw-a", clock=lambda: 0.0)
    regs = [sv.ModelRegistry(sv.ServingServer(_handler(1)), version="v1")
            for _ in range(3)]
    steps = [0]

    def alive():
        steps[0] += 1
        return die_at is None or steps[0] <= die_at

    coord = ds.PromotionBroadcast(regs, control=control, node_id="gw-a",
                                  alive=alive)
    try:
        outcome = coord.broadcast("v2", _handler(2), warmup=False)
    except ds.CoordinatorDied:
        outcome = "died"
    record = control.items("promo/")
    doubt = coord.in_doubt()
    survivor = ds.PromotionBroadcast(regs, control=control, node_id="gw-b")
    recovered = survivor.recover()
    return (outcome, record, doubt, recovered, survivor.in_doubt(),
            control.items("promo/"), [r.active for r in regs],
            survivor.converged(), coord.broadcasts, survivor.recoveries,
            survivor.aborted)


@pytest.mark.parametrize("die_at", [None, 0, 1, 2, 3, 4, 5])
def test_broadcast_records_and_recovery_match_the_reference(die_at):
    got = {name: _broadcast_run(g, ds, sv, die_at)
           for name, (g, ds, sv, _T) in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][7]              # one version fabric-wide


# ---------------------------------------------------------------------------
# replies through both gateways
# ---------------------------------------------------------------------------

def _scaled_handler(Table):
    def handler(df):
        vals = []
        for v in df["value"]:
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                vals.append(v * 2)
            elif isinstance(v, dict):
                vals.append(sorted(v))
            else:
                vals.append(v)
        return Table({"id": df["id"],
                      "reply": np.array(vals, dtype=object)})
    return handler


REQUESTS = [
    ("POST", "/", b'21', {}),
    ("POST", "/", b'"text"', {}),
    ("POST", "/", b'{"x": [[1.0, 2.0], [3.0, 4.0]]}', {}),
    ("POST", "/", b'[1, 2, 3]', {}),
    ("POST", "/", b'2.5', {"X-Batch-Rows": "4"}),
    ("POST", "/", b'{not json', {}),
    ("POST", "/", b'7', {"X-Tenant": "nobody"}),
    ("POST", "/__fabric/unknown", b'{}', {}),
    ("POST", "/__fabric/heartbeat", b'not json', {}),
    ("POST", "/", b'', {}),
]


def _send(url, method, path, body, headers):
    host, port = url.split("//", 1)[1].rstrip("/").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json", **headers})
        r = conn.getresponse()
        payload = r.read()
    finally:
        conn.close()
    try:
        return r.status, json.loads(payload)
    except ValueError:
        return r.status, payload


def test_gateway_replies_match_the_reference():
    got = {}
    for name, (_g, ds, sv, Table) in PACKAGES.items():
        handler = _scaled_handler(Table)
        with sv.ServingServer(handler, port=0, max_batch_latency=0.0) as w1, \
                sv.ServingServer(handler, port=0,
                                 max_batch_latency=0.0) as w2:
            gw = ds.ServingGateway([w1.url, w2.url], port=0,
                                   mode="round_robin").start()
            try:
                got[name] = [_send(gw.url, *r) for r in REQUESTS]
                counts = gw.stats.snapshot()
            finally:
                gw.stop()
        got[name].append({k: counts[k] for k in ("forwarded", "failed",
                                                 "retried")})
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (200, 42)
