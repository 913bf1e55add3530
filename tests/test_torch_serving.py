"""The port's serving layer against the JAX package's, on the CPU.

The same handler behind the JAX ``ServingServer`` and the port's, driven by
the same request script, gives the same replies and statuses: 200 replies,
503 on overflow, 504 at the deadline, row-level failure isolation, drain,
and a tenant flood shed at 429 while the other tenant's replies stay 200.
``respond_with`` gives the same reply tables on its numeric fast path and
its object path. ``QoSController``, ``WeightedFairQueue``,
``CircuitBreaker``, ``RetryBudget``, ``Deadline``, ``Membership`` and
``BudgetLeaseLedger`` give the same decisions for the same events on a fake
clock. ``ModelRegistry`` swaps (``swap_to``, ``prepare``/``commit``/
``abort``, ``rollback``, ``swap_from_store`` over each package's
``CheckpointStore``, a corrupt checkpoint, a kill at every swap stage) leave
both servers on the same versions while a client keeps getting 200s. Then
the CLI: ``serving_main.build_handler`` over a saved and reloaded port
classifier, binary and 7-class categorical, replies as ``transform`` does.

Every HTTP call has a timeout and every server is stopped in a
``finally``, so no test can hang.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from synapseml_tpu.core import checkpoint as jcheckpoint
from synapseml_tpu.core import qos as jqos
from synapseml_tpu.core import resilience as jres
from synapseml_tpu.core.table import Table as JTable
from synapseml_tpu.io import serving as jserving

from synapseml_tpu_torch.core import checkpoint as tcheckpoint
from synapseml_tpu_torch.core import qos as tqos
from synapseml_tpu_torch.core import resilience as tres
from synapseml_tpu_torch.core.table import Table as TTable
from synapseml_tpu_torch.io import serving as tserving
from synapseml_tpu_torch.io import serving_main
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
HTTP_TIMEOUT = 10.0

PKGS = {
    "jax": SimpleNamespace(serving=jserving, qos=jqos, res=jres,
                           Table=JTable, checkpoint=jcheckpoint),
    "torch": SimpleNamespace(serving=tserving, qos=tqos, res=tres,
                             Table=TTable, checkpoint=tcheckpoint),
}


def _post(url, value, headers=None, timeout=HTTP_TIMEOUT):
    """POST a JSON value; (status, parsed body, seconds). HTTP error
    statuses are returned, not raised."""
    req = urllib.request.Request(
        url, data=json.dumps(value).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, payload = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, payload = e.code, e.read()
    elapsed = time.monotonic() - t0
    try:
        body = json.loads(payload.decode()) if payload else None
    except ValueError:
        body = payload
    return status, body, elapsed


def _get(url):
    with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as r:
        return json.loads(r.read().decode())


@contextmanager
def _serving(pkg, handler, **kw):
    srv = pkg.serving.ServingServer(handler, port=0, **kw)
    srv.start()
    try:
        yield srv
    finally:
        srv.stop(drain=False)


def _affine(df):
    """reply = 2 v + 1, or an error for a string value."""
    vals = [v if isinstance(v, (int, float)) else float("nan")
            for v in df["value"]]
    if any(isinstance(v, str) for v in df["value"]):
        raise ValueError("poisoned row")
    return df.with_column("reply", np.asarray(vals, np.float64) * 2.0 + 1.0)


def _both(fn):
    """fn(pkg) for each package: {name: result}."""
    return {name: fn(pkg) for name, pkg in PKGS.items()}


def _same(results):
    assert results["torch"] == results["jax"]
    return results["torch"]


# --------------------------------------------------------------------------
# the batch path, driven directly (no HTTP timing)
# --------------------------------------------------------------------------

def _pending(pkg, value, deadline=None, tenant="default"):
    return pkg.serving._PendingRequest(
        id=uuid.uuid4().hex, method="POST", path="/", headers={},
        body=json.dumps(value).encode(), deadline=deadline,
        admitted_at=time.monotonic(), tenant=tenant)


@pytest.mark.parametrize("case", ["isolation", "no_isolation", "expired",
                                  "dropped_reply", "nonfinite_qos"])
def test_run_batch_matches_the_reference(case):
    def run(pkg):
        handler, kw = _affine, {}
        values = [1, "bad", 3.5]
        deadlines = [None] * 3
        if case == "no_isolation":
            kw["isolate_failures"] = False
        elif case == "expired":
            values = [1, 2]
            deadlines = [pkg.res.Deadline(at=time.monotonic() - 1.0), None]
        elif case == "dropped_reply":
            values = [1, 2]

            def handler(df):
                return df.take([0]).with_column("reply", np.array([7.0]))
        elif case == "nonfinite_qos":
            values = [1, 2]
            kw["qos"] = pkg.qos.QoSController()

            def handler(df):
                return df.with_column("reply", np.array([np.nan, 1.0]))
        srv = pkg.serving.ServingServer(handler, **kw)
        reqs = [_pending(pkg, v, d) for v, d in zip(values, deadlines)]
        srv._run_batch(reqs)
        snap = srv.metrics.snapshot()
        snap.pop("last_queue_age_s")
        out = [(r.response[0], json.loads(r.response[2])) for r in reqs]
        if "qos" in kw:
            q = kw["qos"].snapshot()["default"]
            snap.update(failed=q["failed"], nonfinite=q["nonfinite"])
        return out, snap

    (out, snap) = _same(_both(run))
    assert out and snap["batches"] <= 1


def test_respond_with_matches_the_reference():
    cols = {"id": np.array(["a", "b", "c"], dtype=object),
            "scalar": np.array([1.5, -2.0, 3.25]),
            "vector": np.arange(6, dtype=np.float32).reshape(3, 2),
            "flag": np.array([True, False, True]),
            "status": np.array([200, 500, 200])}
    objs = np.empty(3, dtype=object)
    for i, v in enumerate([np.float32(1.0), np.array([1, 2]), {"k": "v"}]):
        objs[i] = v
    for value_col, status_col in (("scalar", None), ("vector", None),
                                  ("flag", "status"), ("object", None)):
        results = {}
        for name, pkg in PKGS.items():
            t = pkg.Table({**cols, "object": objs})
            results[name] = pkg.serving.respond_with(
                t, value_col=value_col, status_col=status_col)
        _same(results)
    # the fast path and the object path encode the same values alike
    fast = tserving.respond_with(TTable(cols), value_col="scalar")
    boxed = np.empty(3, dtype=object)
    for i, v in enumerate(cols["scalar"]):
        boxed[i] = v
    assert tserving.respond_with(TTable({**cols, "scalar": boxed}),
                                 value_col="scalar") == fast


def test_request_to_table_matches_the_reference():
    def run(pkg):
        reqs = [_pending(pkg, v) for v in ({"a": [1, 2]}, 3.5, "s")]
        reqs.append(pkg.serving._PendingRequest(
            id="raw", method="POST", path="/", headers={}, body=b"\xff"))
        t = pkg.serving.request_to_table(reqs)
        return [(type(v).__name__, repr(v)) for v in t["value"]]

    _same(_both(run))


# --------------------------------------------------------------------------
# HTTP: the same request script against both servers
# --------------------------------------------------------------------------

def test_replies_deadlines_and_metrics_match_the_reference():
    def run(pkg):
        gate = threading.Event()

        def handler(df):
            if any(v == "slow" for v in df["value"]):
                gate.wait(5.0)
                return df.with_column("reply", np.zeros(df.num_rows))
            return _affine(df)

        with _serving(pkg, handler, max_batch_size=8,
                      max_batch_latency=0.0) as srv:
            replies = [_post(srv.url, v)[:2] for v in (1, 2.5, -4, "bad")]
            status, _, elapsed = _post(
                srv.url, "slow", headers={"X-Deadline-Ms": "100"})
            gate.set()
            assert elapsed < 1.0
            snap = _get(srv.url)
        return (replies, status, sorted(snap),
                {k: snap[k] for k in ("accepted", "deadline_expired",
                                      "handler_errors", "draining")})

    replies, status, keys, counters = _same(_both(run))
    assert [s for s, _ in replies] == [200, 200, 200, 500]
    assert [b for _, b in replies[:3]] == [3.0, 6.0, -7.0]
    assert status == 504 and counters["deadline_expired"] == 1


def test_overflow_sheds_503_fast_like_the_reference():
    """One request in the handler, one in the handoff, one held by batch
    formation, ``max_queue_size`` queued: the next is shed at once."""
    def run(pkg):
        gate = threading.Event()

        def handler(df):
            gate.wait(5.0)
            return _affine(df)

        out = []
        with _serving(pkg, handler, max_batch_size=1, max_batch_latency=0.0,
                      max_queue_size=2) as srv:
            with ThreadPoolExecutor(max_workers=8) as pool:
                futures = []
                for i in range(7):
                    futures.append(pool.submit(_post, srv.url, i))
                    deadline = time.monotonic() + 2.0
                    while time.monotonic() < deadline and (
                            srv.metrics["accepted"] + srv.metrics["shed"]
                            < i + 1):
                        time.sleep(0.005)
                    time.sleep(0.05)    # the pipeline stages settle
                shed_fast = [f.result(timeout=HTTP_TIMEOUT)
                             for f in futures if f.done()]
                gate.set()
                results = [f.result(timeout=HTTP_TIMEOUT) for f in futures]
            out = [r[0] for r in results]
            assert all(e < 1.0 for s, _, e in shed_fast if s == 503)
            assert srv.metrics["shed"] == out.count(503)
        return out

    statuses = _same(_both(run))
    assert statuses == [200] * 5 + [503] * 2


def test_drain_completes_in_flight_and_refuses_new_like_the_reference():
    def run(pkg):
        gate = threading.Event()

        def handler(df):
            gate.wait(5.0)
            return _affine(df)

        srv = pkg.serving.ServingServer(handler, port=0, max_batch_size=1,
                                        max_batch_latency=0.0).start()
        try:
            inflight = {}
            t = threading.Thread(
                target=lambda: inflight.update(r=_post(srv.url, 1)))
            t.start()
            deadline = time.monotonic() + 2.0
            while srv.metrics["accepted"] < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            stopper = threading.Thread(target=srv.stop)
            stopper.start()
            while not srv._draining.is_set() and time.monotonic() < deadline:
                time.sleep(0.005)
            late = _post(srv.url, 2)
            gate.set()
            t.join(timeout=HTTP_TIMEOUT)
            stopper.join(timeout=HTTP_TIMEOUT)
            assert not t.is_alive() and not stopper.is_alive()
            return inflight["r"][:2], late[0], late[1]["error"], \
                srv.metrics["drain_rejected"]
        finally:
            gate.set()
            srv.stop(drain=False)

    assert _same(_both(run)) == ((200, 3.0), 503, "server is draining", 1)


def test_tenant_flood_is_shed_while_the_other_tenant_is_served():
    def run(pkg):
        qos = pkg.qos.QoSController(classes={
            "flood": pkg.qos.QoSClass(rate_per_sec=1e-3, burst=2.0)})
        with _serving(pkg, _affine, qos=qos, max_batch_latency=0.0) as srv:
            flood = [_post(srv.url, 1, {"X-Tenant": "flood"})[0]
                     for _ in range(6)]
            calm = [_post(srv.url, i, {"X-Tenant": "calm"})[:2]
                    for i in range(4)]
            snap = qos.snapshot()
        return flood, calm, {t: (s["admitted"], s["rate_limited"])
                             for t, s in snap.items()}

    flood, calm, counts = _same(_both(run))
    assert flood == [200, 200] + [429] * 4
    assert calm == [(200, 2.0 * i + 1.0) for i in range(4)]
    assert counts == {"flood": (2, 4), "calm": (4, 0)}


# --------------------------------------------------------------------------
# QoS and resilience primitives on a fake clock
# --------------------------------------------------------------------------

def test_qos_controller_decisions_match_the_reference():
    def run(pkg):
        t = [0.0]
        q = pkg.qos.QoSController(
            default_class=pkg.qos.QoSClass(rate_per_sec=4.0, burst=3.0,
                                           quarantine_threshold=2,
                                           quarantine_cooldown=1.0),
            classes={"gold": pkg.qos.QoSClass("gold", rate_per_sec=None,
                                              weight=3.0)},
            clock=lambda: t[0])
        log = []
        events = [("admit", "a")] * 5 + [("tick", 0.5)] + [("admit", "a")] * 3
        events += [("fail", "b"), ("fail", "b"), ("admit", "b"),
                   ("admit", "gold"), ("tick", 1.5), ("admit", "b"),
                   ("ok", "b"), ("admit", "b"), ("share", "a"),
                   ("tick", 1.0), ("admit", "a"), ("admit", "a"),
                   ("fail_nan", "b")]
        for kind, arg in events:
            if kind == "tick":
                t[0] += arg
            elif kind == "admit":
                d = q.admit(arg)
                log.append((d.ok, d.status, d.reason))
            elif kind == "fail":
                q.record_failure(arg)
            elif kind == "fail_nan":
                q.record_failure(arg, n=2, nonfinite=True)
            elif kind == "ok":
                q.record_success(arg)
            elif kind == "share":
                q.set_rate_share(arg, 0.5)
            log.append(q.is_quarantined("b"))
        return log, q.snapshot()

    _same(_both(run))


def test_weighted_fair_queue_matches_the_reference():
    def run(pkg):
        q = pkg.qos.QoSController(classes={
            "heavy": pkg.qos.QoSClass(weight=2.0),
            "small": pkg.qos.QoSClass(max_queue=2)})
        wfq = pkg.qos.WeightedFairQueue(maxsize=12, qos=q)
        log = []
        for i in range(5):
            for tenant in ("heavy", "light", "small"):
                try:
                    wfq.put_nowait(SimpleNamespace(id=f"{tenant}{i}",
                                                   tenant=tenant))
                    log.append("put")
                except queue.Full:
                    log.append("full")
        log.append(wfq.snapshot())
        log += [wfq.get_nowait().id for _ in range(7)]
        log.append((wfq.qsize(), wfq.lane_depth("heavy"), wfq.empty()))
        while not wfq.empty():
            log.append(wfq.get(timeout=1.0).id)
        with pytest.raises(queue.Empty):
            wfq.get(timeout=0.01)
        return log

    _same(_both(run))


def test_breaker_budget_deadline_membership_and_leases_match_the_reference():
    def run(pkg):
        t = [10.0]
        clk = lambda: t[0]  # noqa: E731
        res = pkg.res
        log = []
        b = res.CircuitBreaker(failure_threshold=2, cooldown=1.0,
                               max_backoff_mult=4, clock=clk)
        for step in ("f", "f", "acq", "t1.5", "acq", "acq", "f", "t1.5",
                     "acq", "t1.0", "acq", "s", "acq", "f", "f", "f"):
            if step.startswith("t"):
                t[0] += float(step[1:])
            elif step == "f":
                b.record_failure()
            elif step == "s":
                b.record_success()
            else:
                log.append((b.available(), b.try_acquire()))
            log.append(b.snapshot())
        rb = res.RetryBudget(rate_per_sec=2.0, burst=3.0, clock=clk)
        log.append([rb.try_spend() for _ in range(4)])
        t[0] += 1.0
        log.append(([rb.try_spend() for _ in range(3)], rb.spent, rb.denied,
                    rb.available()))
        for header in ("250", "999999", None, "soon", "-5"):
            d = res.Deadline.from_header_ms(header, cap_s=2.0, clock=clk)
            log.append((d.remaining(clk), d.expired(clk),
                        d.header_value(clk)))
        m = res.Membership(timeout=1.0, clock=clk)
        log.append([m.beat("w1", q=1), m.beat("w2"),
                    m.beat("s", static=True), m.beat("w1")])
        t[0] += 1.5
        m.beat("w2")
        log.append((m.expired(), m.alive("w1"), m.evict_stale(),
                    m.beat("w1"), m.members(), m.info("w1")))
        snap = m.snapshot()
        log.append({k: v for k, v in snap.items() if k != "members"})
        ledger = pkg.qos.BudgetLeaseLedger(ttl=1.0, clock=clk)
        ledger.observe("t", "g1")
        ledger.observe("t", "g2")
        log.append((ledger.share("t", "g3"), ledger.holders("t")))
        t[0] += 2.0
        ledger.observe("t", "g2")
        log.append((ledger.share("t", "g2"), ledger.expired,
                    ledger.tenants()))
        ledger.release("t", "g2")
        log.append(ledger.tenants())
        return log

    _same(_both(run))
    assert tres.DEADLINE_HEADER == jres.DEADLINE_HEADER
    assert (tqos.TENANT_HEADER, tqos.DEFAULT_TENANT) == \
        (jqos.TENANT_HEADER, jqos.DEFAULT_TENANT)


# --------------------------------------------------------------------------
# ModelRegistry: swaps never interrupt the serving version
# --------------------------------------------------------------------------

class _Kill(Exception):
    """An injected swap fault."""


def _const(pkg, c, warm=False):
    def handler(df):
        return pkg.Table({"id": df["id"],
                          "reply": np.full(df.num_rows, float(c))})

    if warm:
        handler.warmup = lambda: None
    return handler


@contextmanager
def _client(url, statuses):
    """A client posting in a loop while the block runs."""
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            statuses.append(_post(url, 1)[0])

    t = threading.Thread(target=loop)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join(timeout=HTTP_TIMEOUT)
        assert not t.is_alive()


def test_registry_swaps_match_the_reference(tmp_path):
    def run(pkg):
        sv = pkg.serving
        root = tmp_path / pkg.Table.__module__.split(".")[0]
        srv = sv.ServingServer(_const(pkg, 0), port=0,
                               max_batch_latency=0.0).start()
        statuses, log = [], []

        def probe(label):
            log.append((label, _post(srv.url, 1)[1]))

        def swap_error(call):
            with pytest.raises(sv.SwapError):
                call()

        try:
            with _client(srv.url, statuses):
                reg = sv.ModelRegistry(srv, version="v0")
                probe("v0")
                reg.swap_to("v1", _const(pkg, 1, warm=True))
                probe("swap_to")
                reg.prepare("v2", _const(pkg, 2))
                probe("prepared")
                swap_error(lambda: reg.swap_to("vx", _const(pkg, 9)))
                swap_error(lambda: reg.commit("v9"))
                reg.commit("v2")
                probe("committed")
                reg.prepare("v3", _const(pkg, 3))
                log.append(reg.abort())
                probe("aborted")
                reg.rollback()
                probe("rollback")
                store = pkg.checkpoint.CheckpointStore(str(root / "store"))
                store.save(1, {"model": b"5"})

                def builder(ckpt):
                    return _const(pkg, float(ckpt.artifacts["model"]),
                                  warm=True)

                version = reg.swap_from_store(store, builder)
                probe("from_store")
                log.append(reg.swap_from_store(store, builder) == version)
                store.save(2, {"model": b"6"})
                art = root / "store" / "ckpt_00000002.model"
                art.write_bytes(b"7")            # bit rot after the commit
                swap_error(lambda: reg.swap_from_store(store, builder,
                                                       step=2))
                probe("corrupt")
                swap_error(lambda: reg.swap_from_store(
                    pkg.checkpoint.CheckpointStore(str(root / "empty")),
                    builder))
                for stage in ("load", "build", "warmup", "flip"):
                    def hook(st, version, _at=stage):
                        if st == _at:
                            raise _Kill(st)

                    sv._SWAP_HOOK = hook
                    try:
                        if stage == "load":
                            swap_error(lambda: reg.swap_from_store(
                                store, builder, step=1))
                        else:
                            swap_error(lambda: reg.swap_to(
                                f"k-{stage}", _const(pkg, 8, warm=True)))
                        if stage == "warmup":
                            swap_error(lambda: reg.prepare(
                                "p", _const(pkg, 8, warm=True)))
                    finally:
                        sv._SWAP_HOOK = None
                    probe(f"killed at {stage}")
                snap = reg.snapshot()
                snap.pop("last_error")
                log.append(snap)
                log.append(reg.retire("v0"))
                log.append(sorted(reg.versions))
        finally:
            srv.stop(drain=False)
        assert statuses and set(statuses) == {200}
        return log, srv.metrics["handler_errors"]

    log, _ = _same(_both(run))
    probes = dict(e for e in log if isinstance(e, tuple))
    assert [probes[k] for k in ("v0", "swap_to", "prepared", "committed",
                                "aborted", "rollback", "from_store",
                                "corrupt")] == [0, 1, 1, 2, 2, 1, 5, 5]
    assert [probes[f"killed at {s}"] for s in
            ("load", "build", "warmup", "flip")] == [5.0] * 4


def test_take_over_staged_needs_a_dead_coordinator():
    srv = tserving.ServingServer(_const(PKGS["torch"], 0))
    reg = tserving.ModelRegistry(srv)
    assert reg.take_over_staged() is False
    t = threading.Thread(target=reg.prepare,
                         args=("v1", _const(PKGS["torch"], 1)))
    t.start()
    t.join(timeout=HTTP_TIMEOUT)
    assert reg.take_over_staged() is True
    assert reg.commit() == "v1" and srv.handler is reg.versions["v1"]


# --------------------------------------------------------------------------
# the CLI over saved port models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def saved_models(tmp_path_factory):
    """{name: (saved dir, rows)}: a binary classifier, a 7-class
    classifier with two categorical columns and a regressor, fitted on the
    CPU, saved."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.models import (LightGBMClassifier,
                                            LightGBMRegressor)

    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("models")
    X = rng.normal(size=(400, 4)).astype(np.float32)
    yb = (X[:, 0] + X[:, 1] > 0).astype(np.float64)
    Xc = np.concatenate([X, rng.integers(0, 4, (400, 1)),
                         rng.integers(0, 9, (400, 1))], 1).astype(np.float32)
    y7 = ((Xc[:, 4] + Xc[:, 5] + (X[:, 0] > 0)) % 7).astype(np.float64)
    out = {}
    for name, est, Xm, y, kw in (
            ("binary", LightGBMClassifier, X, yb, {}),
            ("categorical", LightGBMClassifier, Xc, y7,
             dict(categoricalSlotIndexes=[4, 5])),
            ("regression", LightGBMRegressor, X, X[:, 0] * 2.0 + X[:, 1],
             {})):
        model = est(numIterations=3, numLeaves=7, device="cpu", **kw).fit(
            Table({"features": Xm, "label": y}))
        path = str(root / name)
        model.save(path)
        out[name] = (path, Xm[:12])
    return out


@pytest.mark.parametrize("name", ["binary", "categorical", "regression"])
def test_build_handler_replies_as_transform(saved_models, name):
    from synapseml_tpu_torch.core import PipelineStage, Table

    path, rows = saved_models[name]
    stage = PipelineStage.load(path, device="cpu")
    assert stage.booster.device.type == "cpu"
    want = stage.transform(Table({"features": rows}))
    col = "prediction" if name == "regression" else "probability"
    srv = tserving.ServingServer(
        serving_main.build_handler(stage, col), port=0,
        max_batch_latency=0.02)
    srv.start()
    try:
        with ThreadPoolExecutor(max_workers=6) as pool:
            replies = list(pool.map(
                lambda r: _post(srv.url, {"features": r.tolist()}), rows))
        by_col = tserving.ServingServer(
            serving_main.build_handler(stage, "prediction"))
        reqs = [_pending(PKGS["torch"], {"features": r.tolist()})
                for r in rows]
        by_col._run_batch(reqs)
    finally:
        srv.stop()
    assert [s for s, _, _ in replies] == [200] * len(rows)
    got = np.asarray([b for _, b, _ in replies])
    np.testing.assert_allclose(got, want[col], rtol=0, atol=1e-6)
    classes = [json.loads(r.response[2]) for r in reqs]
    assert classes == want["prediction"].tolist()


def test_main_refuses_the_gateway_flags_by_name():
    for argv, flag in ((["--gateway-workers", "http://x:1"],
                        "--gateway-workers"),
                       (["--model", "m", "--lb-mode", "round_robin"],
                        "--lb-mode")):
        with pytest.raises(NotImplementedError, match=flag):
            serving_main.main(argv)


def test_main_serves_a_saved_model_on_the_cpu(saved_models):
    path, rows = saved_models["binary"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "synapseml_tpu_torch.io.serving_main",
         "--model", path, "--device", "cpu", "--port", "0",
         "--host", "127.0.0.1", "--output-col", "probability"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            line = pool.submit(proc.stdout.readline).result(timeout=120)
        assert line.startswith("serving LightGBMClassificationModel on cpu "
                               "at http://127.0.0.1:"), \
            line + proc.stderr.read()
        status, body, _ = _post(line.split(" at ")[1].strip(),
                                {"features": rows[0].tolist()})
        assert status == 200 and len(body) == 2
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=HTTP_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=HTTP_TIMEOUT)
    assert proc.returncode == 0
