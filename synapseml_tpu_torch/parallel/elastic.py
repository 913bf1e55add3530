"""Elastic distributed training: watchdogs, consensus restart, supervision.

Counterpart of the JAX package's ``parallel/elastic.py`` (which imports no
JAX either; the port keeps its own copy on its own checkpoint store). A
killed or hung peer inside a collective would stall a gloo world until the
process group's timeout. Three host-side layers turn that into a
diagnosable, recoverable event:

1. **Collective watchdog** — every process writes a per-rank heartbeat file
   (:class:`HeartbeatWriter`, atomic tmp + rename like the checkpoint
   store); :class:`CollectiveWatchdog` runs the hot blocking call (a train
   step and its device sync, a boosting iteration's tree, a pipeline batch)
   on a daemon worker thread and joins with a budget. On expiry it consults
   the :class:`HeartbeatMonitor`: a stale peer turns the stall into a
   :class:`PeerLostError` naming the lost ranks and their last op; peers
   that are slow but alive (fresh heartbeats) extend the wait up to
   ``straggler_factor`` budgets. ``parallel.collectives`` and
   ``parallel.transfer`` beat the heartbeat before every collective and
   every pipeline hop through ``collectives._WATCHDOG_HOOK``.
2. **Consensus restart** — survivors agree on the restart point with
   :func:`consensus_restart_step`, a digest-verified file barrier (the
   collective fabric is what just broke, so agreement rides durable
   storage): the agreed step is the newest one EVERY survivor verified
   with an identical digest. :func:`elastic_train` wraps a training
   closure with this detect → agree → retry loop; the shrunken or regrown
   resume rides the resharding restore paths
   (``core.checkpoint.load_sharded_from_checkpoint``, the GBDT's
   mesh-independent snapshots).
3. **TrainingSupervisor** — observes rank liveness (process exit and
   heartbeat staleness), respawns lost ranks up to a budget, then shrinks
   the gang to the survivors. ``spawn_fn(rank, world, attempt)`` is the
   hook (a ``subprocess.Popen`` factory, for instance).

Invariant: no committed checkpoint step is ever lost, and a resume on the
same mesh is bitwise the uninterrupted run.

Nothing here imports ``torch``: the watchdog and consensus machinery is
host-side plumbing, importable from worker-management processes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..core.checkpoint import (CheckpointError, CheckpointStore,
                               atomic_write_text)
from ..core.logging import record_failure

HEARTBEAT_PREFIX = "hb_p"


class PeerLostError(RuntimeError):
    """A collective stalled past its watchdog budget.

    ``lost`` names the ranks whose heartbeats went stale (empty when every
    peer still beats — the collective itself is wedged); ``op`` is the
    operation that stalled; ``last_ops`` maps each lost rank to the last op
    its heartbeat reported, which is usually the exact collective it died
    inside."""

    def __init__(self, op: str, lost: Sequence[int], waited_s: float,
                 last_ops: Optional[Dict[int, str]] = None, detail: str = ""):
        self.op = op
        self.lost = sorted(int(r) for r in lost)
        self.waited_s = float(waited_s)
        self.last_ops = dict(last_ops or {})
        if self.lost:
            who = ", ".join(
                f"rank {r} (last op {self.last_ops.get(r, '?')!r})"
                for r in self.lost)
            msg = (f"collective {op!r} stalled {waited_s:.1f}s: peer "
                   f"heartbeat(s) stale — lost {who}")
        else:
            msg = (f"collective {op!r} stalled {waited_s:.1f}s with every "
                   f"peer heartbeat fresh — the collective itself is wedged")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class ElasticUnsupportedError(NotImplementedError):
    """A training configuration outside the elastic-capable matrix.

    Structured so callers can render the supported-config matrix
    (``.matrix``: feature -> supported?) instead of guessing from a bare
    NotImplementedError (``dl.pipeline.SUPPORTED_MATRIX``)."""

    def __init__(self, feature: str, matrix: Dict[str, bool], hint: str = ""):
        self.feature = feature
        self.matrix = dict(matrix)
        rows = "; ".join(f"{k}: {'yes' if v else 'NO'}"
                         for k, v in self.matrix.items())
        msg = f"{feature} is not supported. Supported-config matrix — {rows}."
        if hint:
            msg += f" {hint}"
        super().__init__(msg)


# --- heartbeats -------------------------------------------------------------

def _hb_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"{HEARTBEAT_PREFIX}{int(rank)}.json")


class HeartbeatWriter:
    """Per-rank liveness file: ``hb_p<rank>.json`` written atomically (tmp +
    rename, same discipline as the checkpoint store) so a reader never sees a
    torn beat. ``beat(op, step)`` stamps the last operation this rank
    entered; ``start()`` adds a background daemon beater for phases with no
    natural beat sites (data loading, host-side rebuilds). Idempotent
    ``stop``; usable as a context manager."""

    def __init__(self, directory: str, rank: int, interval: float = 0.25):
        self.dir = directory
        self.rank = int(rank)
        self.interval = float(interval)
        self.path = _hb_path(directory, rank)
        self.seq = 0
        self._last_op = "start"
        self._last_step = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        self.beat("start")

    def beat(self, op: str = "alive", step: int = 0) -> None:
        with self._lock:
            self.seq += 1
            self._last_op, self._last_step = op, int(step)
            payload = {"rank": self.rank, "op": op, "step": int(step),
                       "seq": self.seq, "pid": os.getpid()}
        atomic_write_text(self.path, json.dumps(payload, sort_keys=True))

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            with self._lock:
                op, step = self._last_op, self._last_step
            self.beat(op, step)

    def start(self) -> "HeartbeatWriter":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name=f"heartbeat-p{self.rank}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, remove: bool = False) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2 * self.interval + 1.0)
        if remove:
            try:
                os.remove(self.path)
            except OSError:
                pass   # already gone — a removed beat is a stopped beat

    def __enter__(self) -> "HeartbeatWriter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class HeartbeatMonitor:
    """Reads the heartbeat directory: a rank is *alive* while its beat file's
    mtime is within ``timeout`` seconds, *stale* otherwise (or when the file
    is missing entirely for an ``expected`` rank). ``self_rank`` is excluded
    from staleness — a process never declares itself lost."""

    def __init__(self, directory: str, timeout: float = 2.0,
                 expected: Optional[Sequence[int]] = None,
                 self_rank: Optional[int] = None):
        self.dir = directory
        self.timeout = float(timeout)
        self.expected = (sorted(int(r) for r in expected)
                         if expected is not None else None)
        self.self_rank = self_rank

    def read(self) -> Dict[int, Dict[str, Any]]:
        """rank -> {"age": seconds since last beat, **last payload}."""
        out: Dict[int, Dict[str, Any]] = {}
        if not os.path.isdir(self.dir):
            return out
        now = time.time()
        for fn in os.listdir(self.dir):
            if not (fn.startswith(HEARTBEAT_PREFIX) and fn.endswith(".json")):
                continue
            path = os.path.join(self.dir, fn)
            try:
                rank = int(fn[len(HEARTBEAT_PREFIX):-len(".json")])
                age = now - os.path.getmtime(path)
                with open(path, "r", encoding="utf-8") as f:
                    payload = json.loads(f.read())
            except (OSError, ValueError):
                continue   # torn/vanished beat: treated as missing this poll
            out[rank] = dict(payload, age=age)
        return out

    def alive(self) -> List[int]:
        return sorted(r for r, p in self.read().items()
                      if p["age"] <= self.timeout)

    def stale(self) -> List[int]:
        """Ranks presumed lost: beat older than ``timeout`` or (for expected
        ranks) never written. ``self_rank`` is never reported."""
        seen = self.read()
        ranks = set(seen)
        if self.expected is not None:
            ranks |= set(self.expected)
        out = []
        for r in sorted(ranks):
            if self.self_rank is not None and r == int(self.self_rank):
                continue
            p = seen.get(r)
            if p is None or p["age"] > self.timeout:
                out.append(r)
        return out

    def last_ops(self, ranks: Sequence[int]) -> Dict[int, str]:
        seen = self.read()
        return {int(r): seen[r]["op"] for r in ranks if r in seen}


# --- the watchdog -----------------------------------------------------------

class CollectiveWatchdog:
    """Timeout guard around hot blocking calls (collectives, device syncs).

    ``run(fn, *args, op=...)`` executes ``fn`` on a daemon worker thread and
    joins with ``timeout``. Past the budget it consults the monitor:

    * some peer heartbeat is stale → :class:`PeerLostError` naming the lost
      ranks and their last reported op (``elastic.peer_lost`` counter);
    * every peer still beats → the wait extends, budget by budget, up to
      ``straggler_factor`` × ``timeout`` total (``elastic.straggler_wait``
      counter) — a slow-but-alive straggler is NOT a lost peer;
    * the hard cap expires with all peers fresh → :class:`PeerLostError`
      with ``lost=[]``: the collective itself is wedged
      (``elastic.collective_stall`` counter).

    ``writer`` (optional) is beaten on every ``beat()`` call — the training
    loops and ``parallel.collectives`` route their beats through here so one
    object carries both halves of the protocol. The worker thread is a
    daemon: an abandoned hung call cannot block interpreter exit."""

    def __init__(self, timeout: float = 30.0,
                 monitor: Optional[HeartbeatMonitor] = None,
                 writer: Optional[HeartbeatWriter] = None,
                 straggler_factor: float = 4.0, poll: float = 0.05):
        if timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        self.timeout = float(timeout)
        self.monitor = monitor
        self.writer = writer
        self.straggler_factor = max(float(straggler_factor), 1.0)
        self.poll = float(poll)
        self.stalls = 0          # budget expiries observed (incl. stragglers)
        self.ops_guarded = 0

    def beat(self, op: str = "alive", step: int = 0) -> None:
        if self.writer is not None:
            self.writer.beat(op, step)

    def run(self, fn: Callable, *args, op: Optional[str] = None,
            timeout: Optional[float] = None, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the stall guard; returns its
        result or re-raises its exception. See class docstring for the
        timeout policy."""
        opname = op or getattr(fn, "__name__", "collective")
        budget = float(timeout) if timeout else self.timeout
        hard = budget * self.straggler_factor
        box: Dict[str, Any] = {}
        done = threading.Event()

        def _worker():
            try:
                box["out"] = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                box["err"] = e
            finally:
                done.set()

        self.ops_guarded += 1
        t = threading.Thread(target=_worker, daemon=True,
                             name=f"watchdog-{opname}")
        t.start()
        t0 = time.monotonic()
        warned = False
        while not done.wait(self.poll):
            waited = time.monotonic() - t0
            if waited < budget:
                continue
            self.stalls += not warned
            stale = self.monitor.stale() if self.monitor is not None else []
            if stale:
                last = (self.monitor.last_ops(stale)
                        if self.monitor is not None else {})
                record_failure("elastic.peer_lost", op=opname,
                               lost=list(stale), waited_s=round(waited, 3))
                raise PeerLostError(opname, stale, waited, last_ops=last)
            if waited >= hard:
                record_failure("elastic.collective_stall", op=opname,
                               waited_s=round(waited, 3))
                raise PeerLostError(
                    opname, [], waited,
                    detail="hung past the straggler cap; no rank heartbeat "
                           "is stale — suspect a deadlocked collective or a "
                           "wedged device")
            if not warned:
                warned = True
                record_failure("elastic.straggler_wait", op=opname,
                               budget_s=budget, cap_s=hard)
        if "err" in box:
            raise box["err"]
        return box["out"]


def run_with_budget(fn: Callable, *args, budget_s: float,
                    op: str = "task", **kwargs):
    """One-shot :meth:`CollectiveWatchdog.run` without peer heartbeats: run
    ``fn`` on a reaped daemon thread and raise :class:`PeerLostError`
    (``lost=[]``) once ``budget_s`` elapses. The straggler extension is
    disabled (no monitor means no evidence the task is merely slow), so the
    budget is hard — this is the hang-reaper the elastic AutoML scheduler
    wraps every candidate fit in: the abandoned thread cannot wedge the
    pool, and the caller scores the reaped work NaN instead of waiting."""
    return CollectiveWatchdog(timeout=budget_s, straggler_factor=1.0).run(
        fn, *args, op=op, **kwargs)


# --- global watchdog registry (training loops + collectives consult it) -----

_CURRENT: Optional[CollectiveWatchdog] = None


def current_watchdog() -> Optional[CollectiveWatchdog]:
    """The installed watchdog, or None. Training loops (``train_booster``,
    the streamed pump, the DL trainer and pipeline) wrap their blocking
    step through it and beat per boundary when one is installed; the
    branch costs one global read."""
    return _CURRENT


class elastic_watchdog:
    """Context manager installing ``wd`` as the process-global watchdog AND
    hooking ``parallel.collectives`` so every collective helper and every
    pipeline hop beats the heartbeat with its op name before it moves data
    (the last op a dead rank reported is usually the collective it died
    inside). Nesting is not supported (one global slot, like the chaos
    hook)."""

    def __init__(self, wd: CollectiveWatchdog):
        self.wd = wd

    def __enter__(self) -> CollectiveWatchdog:
        global _CURRENT
        from . import collectives as _c

        if _CURRENT is not None or _c._WATCHDOG_HOOK is not None:
            raise RuntimeError("elastic_watchdog does not nest")
        _CURRENT = self.wd
        _c._WATCHDOG_HOOK = lambda name: self.wd.beat(name)
        return self.wd

    def __exit__(self, *exc) -> None:
        global _CURRENT
        from . import collectives as _c

        _CURRENT = None
        _c._WATCHDOG_HOOK = None


# --- consensus restart ------------------------------------------------------

def verified_steps(store: CheckpointStore) -> Dict[int, str]:
    """step -> whole-checkpoint digest for every checkpoint in ``store`` that
    fully verifies (every artifact passes its manifest digests). A torn or
    bit-rotted checkpoint is simply absent — it cannot be agreed on."""
    out: Dict[int, str] = {}
    for step in store.steps():
        try:
            ck = store.load_step(step)
        except CheckpointError:
            continue
        out[int(step)] = ck.digest
    return out


def consensus_restart_step(store: CheckpointStore, consensus_dir: str,
                           rank: int, expected: Sequence[int], *,
                           timeout: float = 30.0, poll: float = 0.05,
                           epoch: int = 0) -> Optional[int]:
    """Digest-verified survivor barrier: agree on the last fully-committed
    checkpoint step after a failure.

    Generalizes ``core.checkpoint._exchange_json`` to a file barrier — the
    collective fabric that backs the all-gather is exactly what just broke,
    so agreement must ride durable storage instead. Each survivor publishes its
    locally-verified ``{step: digest}`` map (atomic write) under
    ``consensus_dir/epoch_<epoch>/p<rank>.json`` and polls for the full
    ``expected`` set; past ``timeout`` it raises
    ``CheckpointError("barrier timeout, peers=[...]")`` naming the silent
    ranks. The agreed step is the NEWEST step present in every survivor's map
    with an identical digest (None when no common verified step exists —
    restart from scratch). ``epoch`` namespaces successive restart rounds so
    a rank re-running the barrier never reads a previous round's files."""
    d = os.path.join(consensus_dir, f"epoch_{int(epoch):04d}")
    os.makedirs(d, exist_ok=True)
    expected = sorted(set(int(r) for r in expected))
    mine = verified_steps(store)
    atomic_write_text(
        os.path.join(d, f"p{int(rank)}.json"),
        json.dumps({"rank": int(rank),
                    "steps": {str(s): dg for s, dg in mine.items()}},
                   sort_keys=True))
    deadline = time.monotonic() + float(timeout)
    maps: Dict[int, Dict[int, str]] = {}
    while True:
        for r in expected:
            if r in maps:
                continue
            path = os.path.join(d, f"p{r}.json")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    payload = json.loads(f.read())
                maps[r] = {int(s): dg
                           for s, dg in payload.get("steps", {}).items()}
            except (OSError, ValueError):
                pass   # not published yet (or torn mid-write): next poll
        if len(maps) == len(expected):
            break
        if time.monotonic() > deadline:
            missing = sorted(set(expected) - set(maps))
            record_failure("elastic.barrier_timeout", peers=missing,
                           timeout_s=timeout, dir=d)
            raise CheckpointError(
                f"barrier timeout, peers={missing} — survivor(s) never "
                f"published a verified-checkpoint map to {d} within "
                f"{timeout:.1f}s")
        time.sleep(poll)
    common = set(maps[expected[0]])
    for r in expected[1:]:
        common &= set(maps[r])
    agreed = None
    for step in sorted(common, reverse=True):
        if len({maps[r][step] for r in expected}) == 1:
            agreed = step
            break
    record_failure("elastic.consensus", agreed_step=agreed,
                   survivors=expected, epoch=int(epoch))
    return agreed


def elastic_train(train_once: Callable[[int, Optional[int]], Any], *,
                  store: CheckpointStore, consensus_dir: str, rank: int = 0,
                  expected: Sequence[int] = (0,), max_restarts: int = 2,
                  barrier_timeout: float = 30.0,
                  on_restart: Optional[Callable] = None):
    """Detect → agree → resume loop around a training closure.

    ``train_once(attempt, agreed_step)`` runs one training attempt (attempt 0
    passes ``agreed_step=None``); it should rebuild its mesh from whatever
    ranks survive and resume from ``store`` (``train_booster`` and the DL
    trainer do that resume internally). A :class:`PeerLostError` escaping it
    triggers the consensus barrier over the ``expected`` survivor set; the
    retention floor is then pinned so the agreed step still exists when the
    retry loads it. After ``max_restarts`` failed attempts the last error
    propagates. ``on_restart(attempt, agreed_step, error)`` observes each
    transition (tests assert on it; deployments log it)."""
    attempt = 0
    agreed: Optional[int] = None
    while True:
        try:
            return train_once(attempt, agreed)
        except PeerLostError as e:
            attempt += 1
            if attempt > max_restarts:
                raise
            agreed = consensus_restart_step(
                store, consensus_dir, rank, expected,
                timeout=barrier_timeout, epoch=attempt)
            record_failure("elastic.restart", attempt=attempt,
                           agreed_step=agreed, cause=str(e))
            if on_restart is not None:
                on_restart(attempt, agreed, e)


# --- the training-side supervisor -------------------------------------------

class TrainingSupervisor:
    """Respawn-or-shrink supervision of a training gang: a pure ``decide``,
    a one-action ``step`` and an optional daemon loop.

    ``spawn_fn(rank, world, attempt)`` starts one worker and returns a
    process handle exposing ``poll()``/``terminate()``/``kill()``/``wait()``
    (a ``subprocess.Popen``). A rank counts as lost when its process has
    exited OR its heartbeat is stale — covering both a clean crash and a hung
    process that never exits. Policy: each lost rank is respawned up to
    ``max_respawns`` times (regrow); past the budget the gang is shrunk to
    the survivors via ``shrink_fn(new_world)``, which must relaunch training
    at the smaller world (consensus restart + resharding resume do the
    rest). ``retire()`` reaps every child on every exit path."""

    def __init__(self, spawn_fn: Callable[[int, int, int], Any],
                 world_size: int, heartbeat_dir: str, min_world: int = 1,
                 hb_timeout: float = 2.0, interval: float = 0.5,
                 max_respawns: int = 1,
                 shrink_fn: Optional[Callable[[int], Any]] = None):
        if world_size < 1 or min_world < 1 or min_world > world_size:
            raise ValueError("need 1 <= min_world <= world_size")
        self.spawn_fn = spawn_fn
        self.world_size = int(world_size)
        self.min_world = int(min_world)
        self.heartbeat_dir = heartbeat_dir
        self.monitor = HeartbeatMonitor(heartbeat_dir, timeout=hb_timeout,
                                        expected=range(world_size))
        self.interval = float(interval)
        self.max_respawns = int(max_respawns)
        self.shrink_fn = shrink_fn
        self.procs: Dict[int, Any] = {}
        self.respawns: Dict[int, int] = {}
        self.spawned = 0
        self.shrunk = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # guards procs/respawns/spawned/world_size: the supervisor loop
        # mutates the gang while retire()/start_gang() run on the caller's
        # thread. Reentrant — step() takes it and calls observe()/retire().
        self._gang_lock = threading.RLock()

    # -- gang management --
    def start_gang(self) -> "TrainingSupervisor":
        os.makedirs(self.heartbeat_dir, exist_ok=True)
        with self._gang_lock:
            for rank in range(self.world_size):
                self.procs[rank] = self.spawn_fn(rank, self.world_size, 0)
                self.spawned += 1
        return self

    def retire(self) -> None:
        """Terminate and reap every child (idempotent; called on every exit
        path — a supervisor never leaves zombies)."""
        with self._gang_lock:
            for rank, proc in list(self.procs.items()):
                if proc is None:
                    continue
                try:
                    if proc.poll() is None:
                        proc.terminate()
                        try:
                            proc.wait(timeout=5)
                        except Exception:  # noqa: BLE001 — escalate to SIGKILL
                            proc.kill()
                    proc.wait()
                except OSError:
                    pass   # already reaped
                self.procs[rank] = None

    # -- observe / decide / act (FabricSupervisor shape) --
    def observe(self):
        """(alive_ranks, lost_ranks): a rank is lost when its process exited
        or its heartbeat went stale."""
        stale = set(self.monitor.stale())
        alive, lost = [], []
        with self._gang_lock:
            for rank, proc in self.procs.items():
                if proc is None:
                    continue
                exited = proc.poll() is not None
                if exited or rank in stale:
                    lost.append(rank)
                else:
                    alive.append(rank)
        return sorted(alive), sorted(lost)

    def decide(self, n_alive: int, lost: Sequence[int]) -> Optional[str]:
        """Pure policy: "respawn" (every lost rank still under its respawn
        budget), "shrink" (budget exhausted but survivors form a viable
        world), or None (nothing lost / nothing left to do)."""
        if not lost:
            return None
        if all(self.respawns.get(r, 0) < self.max_respawns for r in lost):
            return "respawn"
        if n_alive >= self.min_world and self.shrink_fn is not None:
            return "shrink"
        return None

    def step(self) -> Optional[str]:
        """Observe -> decide -> act once; returns the action taken."""
        alive, lost = self.observe()
        action = self.decide(len(alive), lost)
        if action == "respawn":
            with self._gang_lock:
                for rank in lost:
                    proc = self.procs.get(rank)
                    if proc is not None:
                        try:      # reap the corpse before replacing it
                            if proc.poll() is None:
                                proc.kill()
                            proc.wait()
                        except OSError:
                            pass
                    attempt = self.respawns.get(rank, 0) + 1
                    self.respawns[rank] = attempt
                    self.procs[rank] = self.spawn_fn(rank, self.world_size,
                                                     attempt)
                    self.spawned += 1
                    record_failure("elastic.respawn", rank=rank,
                                   attempt=attempt, world=self.world_size)
        elif action == "shrink":
            survivors = len(alive)
            with self._gang_lock:
                self.retire()                  # drain the old gang fully
                self.world_size = survivors
                self.monitor.expected = list(range(survivors))
                self.respawns.clear()
                self.shrunk += 1
            record_failure("elastic.shrink", new_world=survivors)
            self.shrink_fn(survivors)
        return action

    # -- managed loop --
    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — loop must survive a bad step
                record_failure("elastic.supervisor_error", error=str(e))

    def start(self) -> "TrainingSupervisor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="training-supervisor",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.interval + 5)

    def __enter__(self) -> "TrainingSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
        self.retire()
