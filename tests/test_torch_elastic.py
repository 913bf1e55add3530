"""Elastic training on the port: the scenarios of ``tests/test_elastic.py``.

Single-process (as in the JAX package's file): heartbeats, the collective
watchdog and its installation (the port's ``collectives._WATCHDOG_HOOK``),
a hang planted through ``collectives._CHAOS_HOOK`` (this file's
``_Hang``, the JAX package's ``chaos_hang`` semantics: the ``at_call``-th
call whose op starts with ``op`` blocks until released, and a released
call raises instead of moving data), the consensus barrier, the restart
loop, the training supervisor (real processes through
``subprocess.Popen``), and the watchdog around single-process GBDT.

On 4 gloo CPU ranks (ONE ``torch.multiprocessing`` start for the file;
the JAX file takes 8 virtual devices): GBDT resumed bitwise on the same
mesh, killed on 4 ranks and resumed on 3, killed in one process and
resumed on the mesh, the stale feature route degrading on 3 ranks, and a
torn newest snapshot; DL ZeRO killed on 4 ranks and resumed on 2, and a
watchdog-wrapped fit bitwise the plain one; the pipeline's hop hang under
both schedules, its stage groups shrunk from ``{"stage": 2, "data": 2}`` to
``{"stage": 2, "data": 1}``, a kill and resume on a ``seq`` pipeline mesh,
and the hops beating the watchdog.
"""

import os
import pickle
import signal
import subprocess
import sys
import threading
import time
import warnings
from unittest import mock

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from synapseml_tpu_torch.core.checkpoint import (MANIFEST_SUFFIX,
                                                 CheckpointError,
                                                 CheckpointStore,
                                                 PreemptionError)
from synapseml_tpu_torch.core.logging import (failure_counts,
                                              reset_failure_counts)
from synapseml_tpu_torch.parallel import collectives as C
from synapseml_tpu_torch.parallel.elastic import (CollectiveWatchdog,
                                                  ElasticUnsupportedError,
                                                  HeartbeatMonitor,
                                                  HeartbeatWriter,
                                                  PeerLostError,
                                                  TrainingSupervisor,
                                                  consensus_restart_step,
                                                  current_watchdog,
                                                  elastic_train,
                                                  elastic_watchdog,
                                                  run_with_budget,
                                                  verified_steps)
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)
from torch_waits import PROCESS_S, join_spawn

WORLD = 4
GBDT_TOL = 1e-4            # tests/test_elastic.py: a resharded resume
DL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_counters():
    reset_failure_counts()
    yield
    reset_failure_counts()


class _Hang:
    """Install a hang on ``collectives._CHAOS_HOOK``: the ``at_call``-th
    call whose op name starts with ``op`` blocks for up to ``hang_s``
    seconds or until released (leaving the context releases it); a
    released call raises, so an abandoned worker thread never moves
    data."""

    def __init__(self, op: str = "", at_call: int = 1, hang_s: float = 30.0):
        self.op, self.at_call, self.hang_s = op, int(at_call), float(hang_s)
        self.calls = 0
        self.hung = []
        self._release = threading.Event()

    def release(self):
        self._release.set()

    def _hook(self, name):
        if self.op and not name.startswith(self.op):
            return
        self.calls += 1
        if self.calls == self.at_call:
            self.hung.append(name)
            self._release.wait(self.hang_s)
            raise RuntimeError(f"hung {name} released")

    def __enter__(self):
        if C._CHAOS_HOOK is not None:
            raise RuntimeError("the hang does not nest")
        C._CHAOS_HOOK = self._hook
        return self

    def __exit__(self, *exc):
        C._CHAOS_HOOK = None
        self._release.set()


def _stale_peer(d, peer, op):
    """A heartbeat of ``peer`` that beat once inside ``op`` a minute ago."""
    HeartbeatWriter(d, rank=peer).beat(op)
    past = time.time() - 60
    os.utime(os.path.join(d, f"hb_p{peer}.json"), (past, past))


def _preempt_at(phase, step):
    from synapseml_tpu_torch.core import checkpoint as tck

    def hook(p, s):
        if p == phase and s == step:
            raise PreemptionError(f"killed at {p}[{s}]")
    return mock.patch.object(tck, "_PREEMPT_HOOK", hook)


def _torn_write(ckpt_dir, keep_bytes=7):
    """Truncate the newest checkpoint's artifact, as an interrupted write
    leaves it (the manifest stays)."""
    manifests = sorted(f for f in os.listdir(ckpt_dir)
                       if f.endswith(MANIFEST_SUFFIX))
    base = manifests[-1][: -len(MANIFEST_SUFFIX)]
    path = [os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)
            if f.startswith(base + ".") and not f.endswith(MANIFEST_SUFFIX)
            ][0]
    with open(path, "rb") as f:
        head = f.read(min(keep_bytes, os.path.getsize(path) - 1))
    with open(path, "wb") as f:
        f.write(head)
    return path


# ---------------------------------------------------------------------------
# Heartbeats, the watchdog, the hang
# ---------------------------------------------------------------------------

class TestHeartbeat:
    def test_beat_roundtrip(self, tmp_path):
        d = str(tmp_path)
        w = HeartbeatWriter(d, rank=3, interval=0.05)
        w.beat("allreduce_sum", step=7)
        mon = HeartbeatMonitor(d, timeout=5.0)
        seen = mon.read()
        assert seen[3]["op"] == "allreduce_sum" and seen[3]["step"] == 7
        assert mon.alive() == [3]
        assert mon.last_ops([3]) == {3: "allreduce_sum"}

    def test_stale_and_missing_detection(self, tmp_path):
        d = str(tmp_path)
        HeartbeatWriter(d, rank=0).beat("x")
        mon = HeartbeatMonitor(d, timeout=0.1, expected=[0, 1], self_rank=0)
        assert mon.stale() == [1]
        mon2 = HeartbeatMonitor(d, timeout=0.05, expected=[0, 1])
        time.sleep(0.15)
        assert mon2.stale() == [0, 1]

    def test_background_beater_keeps_fresh(self, tmp_path):
        d = str(tmp_path)
        with HeartbeatWriter(d, rank=0, interval=0.05):
            time.sleep(0.3)
            assert HeartbeatMonitor(d, timeout=0.2).alive() == [0]

    def test_stop_remove(self, tmp_path):
        w = HeartbeatWriter(str(tmp_path), rank=2)
        assert os.path.exists(w.path)
        w.stop(remove=True)
        assert not os.path.exists(w.path)


class TestWatchdog:
    def test_passthrough_result_and_errors(self):
        wd = CollectiveWatchdog(timeout=5.0)
        assert wd.run(lambda a, b: a + b, 2, 3) == 5
        with pytest.raises(ValueError, match="boom"):
            wd.run(lambda: (_ for _ in ()).throw(ValueError("boom")))
        assert wd.ops_guarded == 2 and wd.stalls == 0

    def test_stale_peer_becomes_peer_lost(self, tmp_path):
        d = str(tmp_path)
        _stale_peer(d, 1, "allreduce_sum")
        mon = HeartbeatMonitor(d, timeout=0.5, expected=[0, 1], self_rank=0)
        wd = CollectiveWatchdog(timeout=0.3, monitor=mon)
        t0 = time.monotonic()
        with pytest.raises(PeerLostError) as ei:
            wd.run(lambda: threading.Event().wait(30), op="gbdt.chunk")
        assert time.monotonic() - t0 < 5.0
        e = ei.value
        assert e.lost == [1] and e.op == "gbdt.chunk"
        assert e.last_ops[1] == "allreduce_sum" and "rank 1" in str(e)
        assert failure_counts().get("elastic.peer_lost", 0) == 1

    def test_straggler_is_not_a_false_positive(self, tmp_path):
        d = str(tmp_path)
        with HeartbeatWriter(d, rank=1, interval=0.03):
            mon = HeartbeatMonitor(d, timeout=0.3, expected=[0, 1],
                                   self_rank=0)
            wd = CollectiveWatchdog(timeout=0.15, monitor=mon,
                                    straggler_factor=20.0)
            assert wd.run(lambda: time.sleep(0.5) or "done") == "done"
            assert wd.stalls == 1
        assert failure_counts().get("elastic.straggler_wait", 0) == 1
        assert failure_counts().get("elastic.peer_lost", 0) == 0

    def test_wedged_collective_all_peers_fresh(self, tmp_path):
        d = str(tmp_path)
        with HeartbeatWriter(d, rank=1, interval=0.03):
            mon = HeartbeatMonitor(d, timeout=1.0, expected=[0, 1],
                                   self_rank=0)
            wd = CollectiveWatchdog(timeout=0.15, monitor=mon,
                                    straggler_factor=2.0)
            with pytest.raises(PeerLostError) as ei:
                wd.run(lambda: threading.Event().wait(30), op="dl.step")
            assert ei.value.lost == [] and "wedged" in str(ei.value)
        assert failure_counts().get("elastic.collective_stall", 0) == 1

    def test_no_monitor_times_out_as_wedged(self):
        wd = CollectiveWatchdog(timeout=0.1, straggler_factor=1.5)
        with pytest.raises(PeerLostError):
            wd.run(lambda: threading.Event().wait(30))

    def test_run_with_budget_is_a_hard_budget(self):
        t0 = time.monotonic()
        with pytest.raises(PeerLostError, match="automl.fit"):
            run_with_budget(lambda: threading.Event().wait(30),
                            budget_s=0.2, op="automl.fit")
        assert time.monotonic() - t0 < 5.0
        assert run_with_budget(lambda x: x * 2, 21, budget_s=5.0) == 42


class TestElasticWatchdogInstall:
    def test_install_and_collective_beats(self, tmp_path):
        d = str(tmp_path)
        wd = CollectiveWatchdog(timeout=5.0,
                                writer=HeartbeatWriter(d, rank=0))
        assert current_watchdog() is None
        with elastic_watchdog(wd) as got:
            assert got is wd and current_watchdog() is wd
            assert C._WATCHDOG_HOOK is not None
            C._chaos("reduce_scatter_sum")     # what every helper calls
            assert HeartbeatMonitor(d, timeout=5.0).read()[0]["op"] \
                == "reduce_scatter_sum"
        assert current_watchdog() is None and C._WATCHDOG_HOOK is None

    def test_nesting_rejected(self):
        with elastic_watchdog(CollectiveWatchdog(timeout=1.0)):
            with pytest.raises(RuntimeError, match="nest"):
                with elastic_watchdog(CollectiveWatchdog(timeout=1.0)):
                    pass


class TestChaosHang:
    def test_hang_mid_allreduce_detected(self, tmp_path):
        d = str(tmp_path)
        _stale_peer(d, 1, "allreduce_sum")
        mon = HeartbeatMonitor(d, timeout=0.4, expected=[0, 1], self_rank=0)
        wd = CollectiveWatchdog(timeout=0.25, monitor=mon)
        with _Hang(op="allreduce", hang_s=30.0) as ch:
            with pytest.raises(PeerLostError) as ei:
                # the hook hangs before the helper touches the fabric
                wd.run(lambda: C.allreduce_sum(torch.ones(4), None),
                       op="allreduce_sum")
            assert ch.hung == ["allreduce_sum"]
            assert ei.value.lost == [1]

    def test_release_unblocks(self):
        ch = _Hang(op="allgather", hang_s=30.0)
        with ch:
            box = {}

            def call():
                try:
                    ch._hook("allgather")
                except RuntimeError as e:
                    box["err"] = e
            t = threading.Thread(target=call, daemon=True)
            t0 = time.monotonic()
            t.start()
            time.sleep(0.05)
            ch.release()
            t.join(timeout=5)
            assert not t.is_alive() and time.monotonic() - t0 < 5.0
            assert "released" in str(box["err"])

    def test_does_not_nest(self):
        with _Hang():
            with pytest.raises(RuntimeError, match="nest"):
                with _Hang():
                    pass


# ---------------------------------------------------------------------------
# Consensus restart and the restart loop
# ---------------------------------------------------------------------------

def _store_with(tmpdir, artifacts_by_step):
    s = CheckpointStore(str(tmpdir), keep_last=10)
    for step, blob in artifacts_by_step.items():
        s.save(step, {"state.bin": blob})
    return s


def _agree_in_thread(store, cdir, rank, expected, out):
    t = threading.Thread(target=lambda: out.update(v=consensus_restart_step(
        store, cdir, rank, expected, timeout=10.0)), daemon=True)
    t.start()
    return t


class TestConsensus:
    def test_verified_steps_excludes_torn(self, tmp_path):
        s = _store_with(tmp_path, {1: b"one one", 2: b"two two"})
        _torn_write(str(tmp_path))
        assert set(verified_steps(s)) == {1}

    def test_agreement_on_newest_common_digest(self, tmp_path):
        s0 = _store_with(tmp_path / "r0", {1: b"aa", 2: b"bb", 3: b"cc"})
        s1 = _store_with(tmp_path / "r1", {1: b"aa", 2: b"bb"})
        cdir, out = str(tmp_path / "consensus"), {}
        t = _agree_in_thread(s1, cdir, 1, [0, 1], out)
        agreed = consensus_restart_step(s0, cdir, rank=0, expected=[0, 1],
                                        timeout=10.0)
        t.join(timeout=15)
        assert agreed == 2 and out["v"] == 2
        assert failure_counts().get("elastic.consensus", 0) >= 2

    def test_digest_mismatch_falls_back_to_earlier_step(self, tmp_path):
        s0 = _store_with(tmp_path / "r0", {1: b"aa", 2: b"bb"})
        s1 = _store_with(tmp_path / "r1", {1: b"aa", 2: b"XX"})
        cdir, out = str(tmp_path / "consensus"), {}
        t = _agree_in_thread(s1, cdir, 1, [0, 1], out)
        agreed = consensus_restart_step(s0, cdir, 0, [0, 1], timeout=10.0)
        t.join(timeout=15)
        assert agreed == 1 and out["v"] == 1

    def test_no_common_step_returns_none(self, tmp_path):
        s0 = _store_with(tmp_path / "r0", {1: b"aa"})
        s1 = _store_with(tmp_path / "r1", {2: b"bb"})
        cdir, out = str(tmp_path / "consensus"), {}
        t = _agree_in_thread(s1, cdir, 1, [0, 1], out)
        assert consensus_restart_step(s0, cdir, 0, [0, 1],
                                      timeout=10.0) is None
        t.join(timeout=15)
        assert out["v"] is None

    def test_barrier_timeout_names_silent_ranks(self, tmp_path):
        s = _store_with(tmp_path / "r0", {1: b"aa"})
        with pytest.raises(CheckpointError,
                           match=r"barrier timeout, peers=\[2\]"):
            consensus_restart_step(s, str(tmp_path / "c"), rank=0,
                                   expected=[0, 2], timeout=0.3)
        assert failure_counts().get("elastic.barrier_timeout", 0) == 1

    def test_epochs_are_isolated(self, tmp_path):
        s = _store_with(tmp_path / "r0", {1: b"aa"})
        cdir = str(tmp_path / "c")
        assert consensus_restart_step(s, cdir, 0, [0], epoch=0) == 1
        s.save(2, {"state.bin": b"bb"})
        assert consensus_restart_step(s, cdir, 0, [0], epoch=1) == 2
        assert os.path.isdir(os.path.join(cdir, "epoch_0000"))
        assert os.path.isdir(os.path.join(cdir, "epoch_0001"))


class TestElasticTrainLoop:
    def test_restart_resumes_from_agreed_step(self, tmp_path):
        store = _store_with(tmp_path / "ck", {3: b"model at step three"})
        seen = []

        def train_once(attempt, agreed):
            if attempt == 0:
                raise PeerLostError("dl.step", [1], 0.5)
            return ("model", attempt, agreed)

        result = elastic_train(
            train_once, store=store, consensus_dir=str(tmp_path / "c"),
            rank=0, expected=[0], max_restarts=2,
            on_restart=lambda a, s, e: seen.append((a, s, type(e).__name__)))
        assert result == ("model", 1, 3)
        assert seen == [(1, 3, "PeerLostError")]
        assert failure_counts().get("elastic.restart", 0) == 1

    def test_budget_exhaustion_reraises(self, tmp_path):
        store = _store_with(tmp_path / "ck", {1: b"x"})

        def always_lost(attempt, agreed):
            raise PeerLostError("op", [2], 0.1)

        with pytest.raises(PeerLostError):
            elastic_train(always_lost, store=store,
                          consensus_dir=str(tmp_path / "c"), max_restarts=1)


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------

_BEATER = """
import json, os, sys, time
d, rank = sys.argv[1], sys.argv[2]
path = os.path.join(d, "hb_p%s.json" % rank)
os.makedirs(d, exist_ok=True)
while True:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"rank": int(rank), "op": "child", "step": 0,
                   "seq": 0, "pid": os.getpid()}, f)
    os.replace(tmp, path)
    time.sleep(0.05)
"""


class FakeProc:
    def __init__(self):
        self.exit = None
        self.killed = self.terminated = self.waited = 0

    def poll(self):
        return self.exit

    def kill(self):
        self.killed += 1
        self.exit = -9

    def terminate(self):
        self.terminated += 1
        self.exit = -15

    def wait(self, timeout=None):
        self.waited += 1
        return self.exit


class TestSupervisor:
    def test_decide_is_pure_policy(self, tmp_path):
        sup = TrainingSupervisor(lambda r, w, a: FakeProc(), world_size=4,
                                 heartbeat_dir=str(tmp_path), max_respawns=1,
                                 min_world=2, shrink_fn=lambda w: None)
        assert sup.decide(4, []) is None
        assert sup.decide(3, [2]) == "respawn"
        sup.respawns[2] = 1
        assert sup.decide(3, [2]) == "shrink"
        assert sup.decide(1, [2]) is None
        sup.shrink_fn = None
        assert sup.decide(3, [2]) is None

    def test_respawn_then_shrink_with_fakes(self, tmp_path):
        hb = str(tmp_path / "hb")
        spawned = []

        def spawn(rank, world, attempt):
            spawned.append((rank, world, attempt))
            HeartbeatWriter(hb, rank).beat("child")
            return FakeProc()

        shrunk = []
        sup = TrainingSupervisor(spawn, world_size=3, heartbeat_dir=hb,
                                 hb_timeout=1e9, max_respawns=1, min_world=2,
                                 shrink_fn=shrunk.append)
        sup.start_gang()
        assert sorted(sup.procs) == [0, 1, 2] and sup.spawned == 3
        sup.procs[1].exit = 1
        assert sup.step() == "respawn"
        assert sup.respawns[1] == 1 and spawned[-1] == (1, 3, 1)
        assert failure_counts().get("elastic.respawn", 0) == 1
        sup.procs[1].exit = 1
        assert sup.step() == "shrink"
        assert sup.world_size == 2 and shrunk == [2]
        assert sup.monitor.expected == [0, 1]
        assert failure_counts().get("elastic.shrink", 0) == 1
        sup.retire()
        assert all(p is None for p in sup.procs.values())

    def test_stale_heartbeat_counts_as_lost(self, tmp_path):
        sup = TrainingSupervisor(lambda r, w, a: FakeProc(), world_size=2,
                                 heartbeat_dir=str(tmp_path / "hb"),
                                 hb_timeout=0.1)
        sup.start_gang()
        assert sup.observe() == ([], [0, 1])

    def test_real_processes_kill_respawn_retire(self, tmp_path):
        hb = str(tmp_path / "hb")
        script = tmp_path / "beater.py"
        script.write_text(_BEATER)
        sup = TrainingSupervisor(
            lambda r, w, a: subprocess.Popen([sys.executable, str(script),
                                              hb, str(r)]),
            world_size=2, heartbeat_dir=hb, hb_timeout=5.0, max_respawns=1)
        try:
            sup.start_gang()
            deadline = time.monotonic() + 10
            while len(HeartbeatMonitor(hb, timeout=5.0).read()) < 2:
                assert time.monotonic() < deadline, "children never beat"
                time.sleep(0.05)
            victim = sup.procs[1]
            os.kill(victim.pid, signal.SIGKILL)
            victim.wait(timeout=PROCESS_S)
            assert sup.procs[1].poll() is not None
            assert sup.step() == "respawn"
            assert sup.procs[1].poll() is None
            assert sup.spawned == 3
        finally:
            sup.retire()
        assert all(p is None for p in sup.procs.values())

    def test_supervisor_daemon_loop(self, tmp_path):
        sup = TrainingSupervisor(lambda r, w, a: FakeProc(), world_size=1,
                                 heartbeat_dir=str(tmp_path / "hb"),
                                 hb_timeout=1e9, interval=0.05)
        sup.start_gang()
        with sup:
            sup.start()
            sup.procs[0].exit = 1
            deadline = time.monotonic() + 5
            while sup.respawns.get(0, 0) < 1:
                assert time.monotonic() < deadline
                time.sleep(0.02)
        assert sup._thread is None


# ---------------------------------------------------------------------------
# The structured refusal
# ---------------------------------------------------------------------------

class TestPipelineElasticMatrix:
    def test_error_renders_matrix(self):
        e = ElasticUnsupportedError("frobnication", {"a": True, "b": False},
                                    hint="use a")
        assert isinstance(e, NotImplementedError)
        assert e.matrix == {"a": True, "b": False}
        assert "a: yes" in str(e) and "b: NO" in str(e) and "use a" in str(e)

    def test_unknown_schedule_raises_structured(self):
        from synapseml_tpu_torch.dl import make_staged_backbone
        from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer
        from synapseml_tpu_torch.parallel.mesh import Mesh

        mesh = Mesh({"stage": 2, "data": 4}, 0, {"stage": 0, "data": 0}, {},
                    torch.device("cpu"))
        X, y = _dl_data(32)
        tr = Trainer(make_staged_backbone("tiny", 4, 2),
                     TrainConfig(batch_size=16, max_epochs=1,
                                 param_sharding="pipeline",
                                 pipeline_microbatches=2,
                                 pipeline_schedule="zigzag"),
                     mesh=mesh, device="cpu")
        with pytest.raises(ElasticUnsupportedError, match="zigzag") as ei:
            tr.fit(X, y)
        assert ei.value.matrix["multi-process param_sharding='pipeline'"]
        assert all(ei.value.matrix.values())


# ---------------------------------------------------------------------------
# GBDT and DL in one process: the watchdog around the loops
# ---------------------------------------------------------------------------

def _binary_data(n=397, nfeat=5, seed=0):
    # n divides by neither 4 nor 3: every mesh pads differently
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, nfeat)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def _gbdt_cfg(**kw):
    from synapseml_tpu_torch.gbdt.boosting import BoosterConfig

    return BoosterConfig(**dict(dict(objective="binary", num_iterations=12,
                                     num_leaves=8), **kw))


def _dl_data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=n)
    return X, y


class _Recorder(HeartbeatWriter):
    """A heartbeat writer that keeps every op it beat."""

    def __init__(self, *a, **kw):
        self.ops = []
        super().__init__(*a, **kw)

    def beat(self, op="alive", step=0):
        self.ops.append(op)
        super().beat(op, step)


class TestGbdtWatchdog:
    def test_watchdog_beats_during_training(self, tmp_path):
        from synapseml_tpu_torch.gbdt.boosting import train_booster

        hb = str(tmp_path / "hb")
        wd = CollectiveWatchdog(timeout=120.0,
                                writer=HeartbeatWriter(hb, rank=0))
        X, y = _binary_data(n=200, seed=4)
        with elastic_watchdog(wd):
            train_booster(X, y, _gbdt_cfg(num_iterations=4), device="cpu")
        assert wd.ops_guarded >= 1
        assert HeartbeatMonitor(hb, timeout=1e9).read()[0]["op"] \
            .startswith("gbdt.")

    def test_watchdog_wrapped_run_is_bit_equal(self, tmp_path):
        from synapseml_tpu_torch.gbdt.boosting import train_booster

        X, y = _binary_data(n=200, seed=5)
        ref = train_booster(X, y, _gbdt_cfg(num_iterations=4), device="cpu")
        wd = CollectiveWatchdog(
            timeout=120.0, writer=HeartbeatWriter(str(tmp_path), rank=0))
        with elastic_watchdog(wd):
            got = train_booster(X, y, _gbdt_cfg(num_iterations=4),
                                device="cpu")
        np.testing.assert_array_equal(ref.raw_score(X), got.raw_score(X))

    def test_streamed_pump_beats_each_chunk(self, tmp_path):
        from synapseml_tpu_torch.io.ingest import ChunkPump

        w = _Recorder(str(tmp_path), rank=0)
        with elastic_watchdog(CollectiveWatchdog(timeout=60.0, writer=w)):
            got = list(ChunkPump(iter(range(3)), phase="gbdt.stream.chunk"))
        assert got == [0, 1, 2]
        assert w.ops.count("gbdt.stream.chunk") == 3


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _pipe_trainer(mesh, d=None, **kw):
    from synapseml_tpu_torch.dl import make_staged_backbone
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    base = dict(batch_size=16, max_epochs=4, learning_rate=1e-2, seed=7,
                param_sharding="pipeline", pipeline_microbatches=2,
                pipeline_param_sharding="zero", checkpoint_dir=d)
    base.update(kw)
    torch.manual_seed(0)
    return Trainer(make_staged_backbone("tiny", 4, 2), TrainConfig(**base),
                   mesh=mesh, device="cpu")


def _zero_trainer(mesh, d=None, **kw):
    from synapseml_tpu_torch.dl import make_backbone
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer

    base = dict(batch_size=16, max_epochs=4, learning_rate=1e-2, seed=7,
                param_sharding="zero", checkpoint_dir=d)
    base.update(kw)
    torch.manual_seed(0)
    return Trainer(make_backbone("tiny", 4), TrainConfig(**base), mesh=mesh,
                   device="cpu")


def _hop_hang(rank, workdir, mesh, X, y, **kw):
    """A hang in the pipeline's first (fill_drain) or third (overlap) hop
    on every rank, with a stale peer planted: (op, lost, last op, hung)."""
    d = os.path.join(workdir, f"hb_{kw.get('pipeline_schedule', 'fd')}_"
                              f"{rank}")
    peer = (rank + 1) % WORLD
    _stale_peer(d, peer, "transfer.hop")
    mon = HeartbeatMonitor(d, timeout=2.0, expected=[rank, peer],
                           self_rank=rank)
    # a budget the step's work before the hang stays inside on a loaded
    # host, so the watchdog fires while the step is hung, not before
    wd = CollectiveWatchdog(timeout=1.0, monitor=mon,
                            writer=HeartbeatWriter(d, rank=rank))
    at = 3 if kw.get("pipeline_schedule") == "overlap" else 1
    with _Hang(op="transfer.hop", at_call=at, hang_s=60.0) as ch:
        try:
            with elastic_watchdog(wd):
                _pipe_trainer(mesh, max_epochs=1, **kw).fit(X, y)
        except PeerLostError as e:
            deadline = time.monotonic() + 30
            while not ch.hung and time.monotonic() < deadline:
                time.sleep(0.01)
            return (e.op, e.lost, e.last_ops.get(peer), ch.hung, peer)
    raise AssertionError("the hung hop was not detected")


def _rank_gbdt(rank, workdir, out):
    from synapseml_tpu_torch.gbdt.boosting import train_booster
    from synapseml_tpu_torch.parallel import make_mesh

    X, y = _binary_data()
    mesh4 = make_mesh({"data": 4}, device="cpu")
    mesh3 = make_mesh({"data": 3}, device="cpu", ranks=[0, 1, 2])
    ref = train_booster(X, y, _gbdt_cfg(), mesh=mesh4, device="cpu")
    out["gbdt/ref"] = ref.raw_score(X)
    d = os.path.join(workdir, "gbdt_same")
    try:
        with _preempt_at("gbdt.iteration", 6):
            train_booster(X, y, _gbdt_cfg(), mesh=mesh4, checkpoint_store=d,
                          checkpoint_every=3, device="cpu")
    except PreemptionError:
        pass
    out["gbdt/same"] = train_booster(
        X, y, _gbdt_cfg(), mesh=mesh4, checkpoint_store=d,
        checkpoint_every=3, device="cpu").raw_score(X)
    # kill on 4 ranks, resume on 3 (a rank lost)
    d = os.path.join(workdir, "gbdt_shrink")
    try:
        with _preempt_at("gbdt.iteration", 6):
            train_booster(X, y, _gbdt_cfg(), mesh=mesh4, checkpoint_store=d,
                          checkpoint_every=3, device="cpu")
    except PreemptionError:
        pass
    out["gbdt/committed"] = np.asarray(CheckpointStore(d).steps())
    if mesh3 is not None:
        out["gbdt/shrunk"] = train_booster(
            X, y, _gbdt_cfg(), mesh=mesh3, checkpoint_store=d,
            checkpoint_every=3, device="cpu").raw_score(X)
        out["gbdt/after"] = np.asarray(CheckpointStore(d).steps())
    # one process killed (the parent), the mesh resumes
    out["gbdt/regrown"] = train_booster(
        *_binary_data(seed=2), _gbdt_cfg(), mesh=mesh4,
        checkpoint_store=os.path.join(workdir, "gbdt_one"),
        checkpoint_every=3, device="cpu").raw_score(_binary_data(seed=2)[0])
    # the newest snapshot torn: the previous committed one resumes
    d = os.path.join(workdir, "gbdt_torn")
    try:
        with _preempt_at("gbdt.iteration", 9):
            train_booster(X, y, _gbdt_cfg(), mesh=mesh4, checkpoint_store=d,
                          checkpoint_every=3, device="cpu")
    except PreemptionError:
        pass
    torch.distributed.barrier()
    if rank == 0:
        _torn_write(d)
    torch.distributed.barrier()
    out["gbdt/torn_good"] = np.asarray(sorted(verified_steps(
        CheckpointStore(d))))
    reset_failure_counts()
    out["gbdt/torn"] = train_booster(
        X, y, _gbdt_cfg(), mesh=mesh4, checkpoint_store=d,
        checkpoint_every=3, device="cpu").raw_score(X)
    out["gbdt/fallbacks"] = np.asarray(
        failure_counts().get("checkpoint.fallback", 0))
    # a feature route from the 4-rank mesh on 3 ranks: 12 features pad to
    # 16, which 3 does not divide
    if mesh3 is not None:
        Xf, yf = _binary_data(nfeat=12, seed=4)
        out["gbdt/data3"] = train_booster(
            Xf, yf, _gbdt_cfg(tree_learner="data"), mesh=mesh3,
            device="cpu").raw_score(Xf)
        stale = _gbdt_cfg(tree_learner="feature")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out["gbdt/feature3"] = train_booster(
                Xf, yf, stale, mesh=mesh3, device="cpu").raw_score(Xf)
        out["gbdt/feature3_warned"] = np.asarray(any(
            "falling back to data-parallel" in str(w.message)
            for w in caught))
        out["gbdt/feature3_learner"] = np.asarray(stale.tree_learner)


def _rank_dl(rank, workdir, out):
    from synapseml_tpu_torch.parallel import make_mesh

    X, y = _dl_data()
    mesh4 = make_mesh({"data": 4}, device="cpu")
    mesh2 = make_mesh({"data": 2}, device="cpu", ranks=[0, 1])
    d = os.path.join(workdir, "dl_zero")
    try:
        with _preempt_at("dl.epoch", 2):
            _zero_trainer(mesh4, d).fit(X, y)
    except PreemptionError:
        pass
    out["dl/committed"] = np.asarray(CheckpointStore(d).steps())
    if mesh2 is not None:
        out["dl/ref"] = np.asarray(_zero_trainer(mesh2).fit(X, y)
                                   .history[-1]["loss"])
        tr = _zero_trainer(mesh2, d).fit(X, y)
        out["dl/resumed"] = np.asarray(tr.history[-1]["loss"])
        out["dl/epochs"] = np.asarray([h["epoch"] for h in tr.history])
    X1, y1 = _dl_data(seed=1)
    ref = _zero_trainer(mesh4, max_epochs=2).fit(X1, y1)
    w = _Recorder(os.path.join(workdir, f"hb_dl_{rank}"), rank=rank)
    wd = CollectiveWatchdog(timeout=120.0, writer=w)
    with elastic_watchdog(wd):
        got = _zero_trainer(mesh4, max_epochs=2).fit(X1, y1)
    out["dl/wd_equal"] = np.asarray(np.array_equal(ref.predict_logits(X1),
                                                   got.predict_logits(X1)))
    out["dl/wd_guarded"] = np.asarray(wd.ops_guarded)
    out["dl/wd_steps"] = np.asarray(w.ops.count("dl.step"))


def _rank_pipeline(rank, workdir, out):
    from synapseml_tpu_torch.dl import staged_text_encoder
    from synapseml_tpu_torch.dl.trainer import TrainConfig, Trainer
    from synapseml_tpu_torch.parallel import make_mesh

    X, y = _dl_data(n=32)
    big = make_mesh({"stage": 2, "data": 2}, device="cpu")
    small = make_mesh({"stage": 2, "data": 1}, device="cpu", ranks=[0, 1])
    seq = make_mesh({"stage": 2, "seq": 2}, device="cpu")
    for sched in ("fill_drain", "overlap"):
        out[f"pipe/hang_{sched}"] = np.asarray(repr(_hop_hang(
            rank, workdir, big, X, y, pipeline_schedule=sched)))
    X, y = _dl_data()
    d = os.path.join(workdir, "pipe_shrink")
    try:
        with _preempt_at("dl.epoch", 2):
            _pipe_trainer(big, d).fit(X, y)
    except PreemptionError:
        pass
    out["pipe/committed"] = np.asarray(CheckpointStore(d).steps())
    if small is not None:
        out["pipe/ref"] = np.asarray(_pipe_trainer(small).fit(X, y)
                                     .history[-1]["loss"])
        tr = _pipe_trainer(small, d).fit(X, y)
        out["pipe/resumed"] = np.asarray(tr.history[-1]["loss"])
        out["pipe/epochs"] = np.asarray([h["epoch"] for h in tr.history])
    # kill and resume on a seq pipeline mesh, bitwise
    rng = np.random.default_rng(0)
    T = rng.integers(0, 64, size=(64, 16)).astype(np.int32)
    ty = rng.integers(0, 2, size=64)

    def text(d=None):
        torch.manual_seed(0)
        model = staged_text_encoder(vocab_size=64, num_classes=2,
                                    num_stages=2, num_layers=2, hidden=16,
                                    heads=2, max_len=16)
        return Trainer(model, TrainConfig(
            batch_size=16, max_epochs=4, learning_rate=1e-2, seed=7,
            param_sharding="pipeline", pipeline_microbatches=2,
            pipeline_param_sharding="zero", seq_attention="ring",
            checkpoint_dir=d), mesh=seq, device="cpu")

    ref = text().fit(T, ty)
    out["seq/variant"] = np.asarray(ref.stats["seq_attention"])
    d = os.path.join(workdir, "pipe_seq")
    try:
        with _preempt_at("dl.epoch", 2):
            text(d).fit(T, ty)
    except PreemptionError:
        pass
    out["seq/equal"] = np.asarray(np.array_equal(
        ref.predict_logits(T), text(d).fit(T, ty).predict_logits(T)))
    # the hops beat the watchdog; the fit's last beat is its host fetch
    X, y = _dl_data(n=32)
    hb = os.path.join(workdir, f"hb_pipe_{rank}")
    w = _Recorder(hb, rank=rank)
    wd = CollectiveWatchdog(timeout=120.0, writer=w)
    with elastic_watchdog(wd):
        _pipe_trainer(big, max_epochs=1).fit(X, y)
    out["pipe/wd_guarded"] = np.asarray(wd.ops_guarded)
    out["pipe/wd_last"] = np.asarray(
        HeartbeatMonitor(hb, timeout=1e9).read()[rank]["op"])
    out["pipe/wd_ops"] = np.asarray(sorted(set(w.ops)))


def _rank_main(rank, workdir):
    """One rank: the GBDT, DL and pipeline scenarios; imports nothing of
    JAX."""
    from synapseml_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed("gloo", os.path.join(workdir, "store"), rank, WORLD,
                     timeout_s=120)
    out = {}
    _rank_gbdt(rank, workdir, out)
    _rank_dl(rank, workdir, out)
    _rank_pipeline(rank, workdir, out)
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(one process's results, [each rank's results])."""
    from synapseml_tpu_torch.gbdt.boosting import train_booster

    workdir = tmp_path_factory.mktemp("elastic_ranks")
    X, y = _binary_data(seed=2)
    one = {"regrow/ref": train_booster(X, y, _gbdt_cfg(),
                                       device="cpu").raw_score(X)}
    try:
        with _preempt_at("gbdt.iteration", 6):
            train_booster(X, y, _gbdt_cfg(), device="cpu",
                          checkpoint_store=str(workdir / "gbdt_one"),
                          checkpoint_every=3)
    except PreemptionError:
        pass
    join_spawn(mp.start_processes(_rank_main, args=(str(workdir),),
                                  nprocs=WORLD, join=False,
                                  start_method="spawn"),
               what=f"the {WORLD}-rank spawn")
    ranks = []
    for r in range(WORLD):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return one, ranks


class TestGbdtElastic:
    def test_same_mesh_resume_bit_equal(self, spawned):
        for r in spawned[1]:
            np.testing.assert_array_equal(r["gbdt/same"], r["gbdt/ref"])

    def test_kill_then_shrink_4_to_3(self, spawned):
        """Killed on 4 ranks, resumed on 3: the padded layout changes, the
        model does not; no committed step is lost."""
        for r in spawned[1][:3]:
            assert len(r["gbdt/committed"])
            assert max(r["gbdt/after"]) >= max(r["gbdt/committed"])
            np.testing.assert_allclose(r["gbdt/shrunk"], r["gbdt/ref"],
                                       rtol=GBDT_TOL, atol=GBDT_TOL)

    def test_kill_then_regrow_to_mesh(self, spawned):
        one, ranks = spawned
        for r in ranks:
            np.testing.assert_allclose(r["gbdt/regrown"], one["regrow/ref"],
                                       rtol=GBDT_TOL, atol=GBDT_TOL)

    def test_stale_feature_route_degrades_on_shrunken_mesh(self, spawned):
        for r in spawned[1][:3]:
            assert bool(r["gbdt/feature3_warned"])
            assert str(r["gbdt/feature3_learner"]) == "data"
            np.testing.assert_array_equal(r["gbdt/feature3"],
                                          r["gbdt/data3"])

    def test_kill_mid_checkpoint_resumes_previous_good(self, spawned):
        for r in spawned[1]:
            assert list(r["gbdt/torn_good"]) == [3, 6]
            np.testing.assert_array_equal(r["gbdt/torn"], r["gbdt/ref"])
        assert spawned[1][0]["gbdt/fallbacks"] >= 1


class TestDlElastic:
    def test_kill_then_shrink_4_to_2(self, spawned):
        for r in spawned[1][:2]:
            assert len(r["dl/committed"])
            np.testing.assert_allclose(r["dl/resumed"], r["dl/ref"],
                                       atol=DL_TOL)
            assert list(r["dl/epochs"]) == [2, 3]

    def test_watchdog_beats_and_bit_equal(self, spawned):
        for r in spawned[1]:
            assert bool(r["dl/wd_equal"])
            assert int(r["dl/wd_guarded"]) == 8      # 2 epochs x 4 steps
            assert int(r["dl/wd_steps"]) == 8


class TestPipelineElastic:
    @pytest.mark.parametrize("schedule", ["fill_drain", "overlap"])
    def test_hang_in_hop_detected(self, spawned, schedule):
        """A peer dying inside an inter-group hop surfaces as PeerLostError
        from the watchdog-guarded pipeline step, naming the hop."""
        for r in spawned[1]:
            op, lost, last, hung, peer = eval(str(r[f"pipe/hang_{schedule}"]))
            assert op == "dl.pipeline.step"
            assert lost == [peer] and last == "transfer.hop"
            assert hung == ["transfer.hop"]

    def test_kill_then_shrink_stage_groups(self, spawned):
        """Killed on {"stage": 2, "data": 2}, resumed on {"stage": 2,
        "data": 1}: the per-stage ZeRO checkpoint reshards on load."""
        for r in spawned[1][:2]:
            assert len(r["pipe/committed"])
            np.testing.assert_allclose(r["pipe/resumed"], r["pipe/ref"],
                                       atol=DL_TOL)
            assert list(r["pipe/epochs"]) == [2, 3]

    def test_kill_resume_bit_equal_on_seq_mesh(self, spawned):
        for r in spawned[1]:
            assert str(r["seq/variant"]) == "ring"
            assert bool(r["seq/equal"])

    def test_watchdog_sees_hop_beats(self, spawned):
        for r in spawned[1]:
            assert int(r["pipe/wd_guarded"]) == 2    # 32 rows, batch 16
            assert str(r["pipe/wd_last"]) == "transfer.fetch"
            ops = set(r["pipe/wd_ops"].tolist())
            assert {"transfer.hop", "dl.pipeline.hop",
                    "dl.pipeline.step"} <= ops
