"""Elastic successive-halving scheduler — preemptible AutoML on the gang.

``automl/tune.py`` used to be a bare ThreadPoolExecutor: no early stopping,
no hang detection, and a crash anywhere wedged one pool slot forever. This
module rebuilds that substrate as an ASHA-style successive-halving bracket
(Li et al., arXiv:1810.05934) in which every candidate is a *preemptible
elastic job*:

* **Rungs** — the resource axis is cumulative CV folds. ``plan_rungs`` lays
  a geometric ladder (``eta``): every candidate runs ``min_resource`` folds
  at rung 0, only the top ``ceil(n/eta)`` advance and run up to
  ``min_resource*eta`` folds, and so on until the survivors of the last rung
  hold full-``total_resource`` CV scores. Execution inside a rung is
  asynchronous (any pool order); promotion happens at a *deterministic rung
  barrier*: survivors are ranked by score with NaN always last and ties
  broken by first-seen candidate index, so two runs of the same bracket —
  interrupted or not — promote identically.
* **Budgeted tasks** — each rung task runs under a
  :func:`~synapseml_tpu_torch.parallel.elastic.run_with_budget` reaper (the
  ``CollectiveWatchdog`` machinery without peer heartbeats): a hung
  candidate raises ``PeerLostError`` at the budget, is scored NaN
  (``automl.candidate_hang``), and its pool slot is freed — the abandoned
  daemon thread cannot wedge the bracket. The budget itself is priced by
  ``core/perfmodel.py`` ("automl_rung" rows) when the model is confident,
  and observed rung times are journaled back as training rows.
* **Crash respawn** — a candidate that raises is retried in place up to
  ``max_attempts`` (``automl.candidate_retry`` per retry); only terminal
  failure scores NaN and counts ``automl.candidate_failure`` once.
* **Checkpointed bracket state** — per-candidate fold scores, attempt
  counters, and every promotion decision persist through ``CheckpointStore``
  (atomic, digest-verified) after every completed task and every barrier,
  keyed by a search *fingerprint* (data digest + space + metric + folds).
  kill -9 at any point — mid-candidate, mid-rung, mid-promotion — resumes to
  the identical best model; a resume against a different fingerprint refuses
  loudly instead of silently reusing stale scores.
* **Gang scheduling** — tasks run on the in-process ``LocalElasticPool`` by
  default; :class:`GangCandidatePool` spools them to a
  ``TrainingSupervisor``-managed gang of ``automl/worker.py`` processes
  (heartbeats, respawn-on-crash, ``kill_rank``-able) for callers whose
  candidate entry points are importable.

``testing.chaos.chaos_candidate`` installs :data:`_CHAOS_HOOK` to inject
seeded crash/hang/NaN/slowdown per (candidate, rung, attempt); because the
action is a pure function of those coordinates plus the seed, a chaotic run
is still deterministic across kill→resume. See docs/automl.md.

The port's copy of the JAX package's ``automl/scheduler.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..core import perfmodel
from ..core.checkpoint import CheckpointStore
from ..core.logging import record_failure
from ..parallel.elastic import PeerLostError, run_with_budget

__all__ = ["RungSpec", "plan_rungs", "BracketState",
           "ElasticHalvingScheduler", "GangCandidatePool",
           "fingerprint_digest", "PERF_KIND"]

#: perfmodel decision family for rung-time rows: the learned cost model
#: prices the search, not just kernels
PERF_KIND = "automl_rung"

#: chaos hook slot — ``testing.chaos.chaos_candidate`` installs a callable
#: ``hook(key, rung, attempt) -> Optional[str]`` invoked inside the budgeted
#: task thread; it may raise (crash), block (hang — reaped by the budget),
#: sleep (slowdown) or return ``"nan"`` to poison the metric. Single global
#: slot, same pattern as ``core.checkpoint._PREEMPT_HOOK``.
_CHAOS_HOOK: Optional[Callable[[str, int, int], Optional[str]]] = None

#: watchdog budget = safety × predicted rung seconds (priced mode)
_BUDGET_SAFETY = 4.0
_MIN_PRICED_BUDGET_S = 1.0
_PRICE_MIN_CONFIDENCE = 0.5


# --------------------------------------------------------------------- rungs

@dataclass(frozen=True)
class RungSpec:
    """One rung: ``survivors`` candidates each holding ``resource``
    cumulative folds by the rung's barrier."""
    index: int
    resource: int        # cumulative folds completed at this rung's barrier
    survivors: int       # candidates entering this rung


def plan_rungs(n_candidates: int, total_resource: int, eta: int = 3,
               min_resource: int = 1) -> List[RungSpec]:
    """Geometric successive-halving ladder.

    ``eta <= 1`` (or a single candidate, or no room between ``min_resource``
    and ``total_resource``) degenerates to ONE rung at full resource — the
    exhaustive-CV behavior the pre-bracket searcher had. The final rung is
    always at ``total_resource`` so the winner's metric is a full-CV score,
    directly comparable with exhaustive search.
    """
    n = max(int(n_candidates), 1)
    total = max(int(total_resource), 1)
    lo = max(min(int(min_resource), total), 1)
    if eta <= 1 or n <= 1 or lo >= total:
        return [RungSpec(0, total, n)]
    rungs: List[RungSpec] = []
    res, surv = lo, n
    while True:
        rungs.append(RungSpec(len(rungs), res, surv))
        if res >= total or surv <= 1:
            break
        surv = max(1, math.ceil(surv / eta))
        res = min(total, res * eta)
    if rungs[-1].resource != total:   # cap the ladder at full CV
        rungs.append(RungSpec(len(rungs), total,
                              max(1, math.ceil(rungs[-1].survivors / eta))))
    return rungs


def fingerprint_digest(fingerprint: Dict[str, Any]) -> str:
    """Stable digest of the search identity (data/space/metric/folds)."""
    blob = json.dumps(fingerprint, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:24]


# --------------------------------------------------------------- bracket state

@dataclass
class BracketState:
    """Everything a resume needs, JSON-serializable for ``CheckpointStore``.

    ``fold_scores[key]`` grows monotonically (one entry per completed fold);
    ``promoted[rung]`` records each barrier decision verbatim so a resumed
    bracket REPLAYS past promotions instead of recomputing them — the
    decisions, not just the scores, are part of the checkpoint."""
    fingerprint: str = ""
    fold_scores: Dict[str, List[float]] = field(default_factory=dict)
    final: Dict[str, float] = field(default_factory=dict)
    failed: Dict[str, str] = field(default_factory=dict)   # key -> crash|hang
    attempts: Dict[str, int] = field(default_factory=dict)
    promoted: Dict[str, List[str]] = field(default_factory=dict)  # rung->keys
    rung: int = 0            # first rung whose barrier has NOT been crossed
    events: int = 0          # monotonic save counter (checkpoint step)

    def to_bytes(self) -> bytes:
        return json.dumps({
            "fingerprint": self.fingerprint,
            "fold_scores": self.fold_scores,
            "final": self.final,
            "failed": self.failed,
            "attempts": self.attempts,
            "promoted": self.promoted,
            "rung": self.rung,
            "events": self.events,
        }, sort_keys=True).encode("utf-8")

    @classmethod
    def from_bytes(cls, data: bytes) -> "BracketState":
        d = json.loads(data.decode("utf-8"))
        return cls(fingerprint=d.get("fingerprint", ""),
                   fold_scores={k: [float(s) for s in v]
                                for k, v in d.get("fold_scores", {}).items()},
                   final={k: float(v) for k, v in d.get("final", {}).items()},
                   failed=dict(d.get("failed", {})),
                   attempts={k: int(v)
                             for k, v in d.get("attempts", {}).items()},
                   promoted={k: list(v)
                             for k, v in d.get("promoted", {}).items()},
                   rung=int(d.get("rung", 0)),
                   events=int(d.get("events", 0)))


# ------------------------------------------------------------------ scheduler

class ElasticHalvingScheduler:
    """Run one successive-halving bracket over deduplicated candidates.

    ``run_folds(index, params, lo, hi)`` fits folds ``[lo, hi)`` for one
    candidate and returns their scores (list of floats; NaN allowed). It is
    invoked on a budgeted daemon thread and may raise — ``Exception`` means
    crash (retried), ``PeerLostError``/budget expiry means hang (reaped),
    and ``BaseException`` (``PreemptionError``) aborts the bracket after the
    rung's in-flight siblings drain, so their work is checkpointed first.

    ``candidates``/``keys`` are parallel lists; duplicate keys (a random
    space drawing the same point twice) collapse to ONE execution whose
    score every duplicate shares. ``completed`` maps keys to terminal
    metrics recovered from per-candidate resume records — those keys never
    execute again.
    """

    def __init__(self, run_folds: Callable[[int, Dict[str, Any], int, int],
                                           Sequence[float]],
                 candidates: Sequence[Dict[str, Any]],
                 keys: Sequence[str], *,
                 maximize: bool = True,
                 total_folds: int = 3,
                 eta: int = 0,
                 min_resource: int = 1,
                 parallelism: int = 4,
                 max_attempts: int = 2,
                 budget_s: Optional[float] = None,
                 rung_time_budget_s: Optional[float] = None,
                 store: Optional[CheckpointStore] = None,
                 fingerprint: Optional[Dict[str, Any]] = None,
                 completed: Optional[Dict[str, float]] = None,
                 perf_features: Optional[Dict[str, float]] = None,
                 perf_journal: bool = False,
                 pool: Optional["GangCandidatePool"] = None,
                 gang_task: Optional[Callable[[Dict[str, Any], int, int],
                                              Dict[str, Any]]] = None,
                 invalidate: Optional[Sequence[str]] = None):
        if len(candidates) != len(keys):
            raise ValueError("candidates and keys must be parallel lists")
        self.run_folds = run_folds
        self.maximize = bool(maximize)
        self.total_folds = max(int(total_folds), 1)
        self.parallelism = max(int(parallelism), 1)
        self.max_attempts = max(int(max_attempts), 1)
        self.budget_s = float(budget_s) if budget_s else None
        self.rung_time_budget_s = (float(rung_time_budget_s)
                                   if rung_time_budget_s else None)
        self.store = store
        self.perf_features = dict(perf_features or {})
        self.perf_journal = bool(perf_journal)
        self.pool = pool
        self.gang_task = gang_task

        # dedup: first-seen order defines the execution set AND the
        # deterministic tie-break for promotions
        self.params: Dict[str, Dict[str, Any]] = {}
        self.first_index: Dict[str, int] = {}
        self.order: List[str] = []
        self.duplicates = 0
        for i, (p, k) in enumerate(zip(candidates, keys)):
            if k in self.params:
                self.duplicates += 1
                continue
            self.params[k] = p
            self.first_index[k] = i
            self.order.append(k)

        self.rungs = plan_rungs(len(self.order), self.total_folds,
                                eta=eta, min_resource=min_resource)
        self.fp_digest = fingerprint_digest(fingerprint or {})
        self._lock = threading.Lock()
        self.state = self._restore()
        for k in (invalidate or ()):
            # a corrupt/stale resume record poisons ALL memory of that
            # candidate — its folds recompute from scratch, deterministically
            self.state.fold_scores.pop(k, None)
            self.state.final.pop(k, None)
            self.state.failed.pop(k, None)
            self.state.attempts.pop(k, None)
        for k, v in (completed or {}).items():
            if k in self.params and k not in self.state.final:
                self.state.final[k] = float(v)
        self._record_hooks: List[Callable[[str, float, int], None]] = []

    # -- resume -----------------------------------------------------------
    def _restore(self) -> BracketState:
        if self.store is not None:
            ck = self.store.load_latest()
            if ck is not None:
                saved_fp = str(ck.meta.get("fingerprint", ""))
                if saved_fp != self.fp_digest:
                    raise ValueError(
                        "automl bracket resume refused: checkpoint "
                        f"fingerprint {saved_fp!r} does not match this "
                        f"search {self.fp_digest!r} — the data, search "
                        "space, metric or fold count changed. Point "
                        "checkpointDir at a fresh directory (or delete the "
                        "stale one) instead of silently reusing scores.")
                return BracketState.from_bytes(ck.artifacts["bracket.json"])
        return BracketState(fingerprint=self.fp_digest)

    def _save(self) -> None:
        if self.store is None:
            return
        self.state.events += 1
        self.store.save(self.state.events,
                        {"bracket.json": self.state.to_bytes()},
                        meta={"fingerprint": self.fp_digest})

    def on_candidate_done(self, hook: Callable[[str, float, int],
                                               None]) -> None:
        """Register ``hook(key, metric, folds_done)`` fired (under the state
        lock) when a candidate's participation ends — completion at full
        resource or elimination at a barrier. tune.py journals its
        ``cand_<key>.json`` resume records from here."""
        with self._lock:
            self._record_hooks.append(hook)

    # -- scores -----------------------------------------------------------
    def _mean(self, key: str) -> float:
        if key in self.state.final:
            return self.state.final[key]
        scores = self.state.fold_scores.get(key, [])
        if not scores:
            return float("nan")
        good = [s for s in scores if not math.isnan(s)]
        return sum(good) / len(good) if good else float("nan")

    def results(self) -> Dict[str, Dict[str, float]]:
        """key -> {metric, folds} for every deduplicated candidate."""
        out = {}
        for k in self.order:
            held = self.state.fold_scores.get(k, [])
            # a record-restored candidate has no fold history: report full
            # resource, the only rung a terminal record is written at
            folds = len(held) if held else (
                self.total_folds if k in self.state.final else 0)
            out[k] = {"metric": self._mean(k), "folds": folds}
        return out

    def finalists(self) -> List[str]:
        """Ranked non-NaN survivors of the last rung (may be empty when
        chaos killed every finalist — callers fall back to partial scores)."""
        return list(self.state.promoted.get(str(len(self.rungs) - 1), []))

    # -- perfmodel pricing -------------------------------------------------
    def _fold_features(self, n_folds: int) -> Dict[str, float]:
        f = dict(self.perf_features)
        f["folds"] = float(n_folds)
        return f

    def _predicted_chunk_s(self, n_folds: int) -> perfmodel.Prediction:
        return perfmodel.predict(perfmodel.Candidate(
            kind=PERF_KIND, arm="cv_fold",
            features=self._fold_features(n_folds)))

    def _task_budget(self, n_folds: int) -> Optional[float]:
        """Explicit budget wins; otherwise price one from the learned model
        (safety-factored) when it is confident; otherwise no reaper — a slow
        legitimate candidate must never be killed on a guess."""
        if self.budget_s is not None:
            return self.budget_s
        pred = self._predicted_chunk_s(n_folds)
        if pred.confidence >= _PRICE_MIN_CONFIDENCE and \
                math.isfinite(pred.seconds):
            return max(_MIN_PRICED_BUDGET_S, _BUDGET_SAFETY * pred.seconds)
        return None

    def _journal(self, n_folds: int, observed_s: float, rung: int) -> None:
        if not self.perf_journal:
            return
        try:
            perfmodel.append_training_row(
                PERF_KIND, "cv_fold", self._fold_features(n_folds),
                observed_s, rung=rung)
        except OSError:
            pass    # a read-only journal must not fail the search

    # -- task execution ----------------------------------------------------
    def _execute(self, key: str, rung: RungSpec, lo: int, hi: int,
                 attempt: int) -> Sequence[float]:
        """One attempt: chaos hook, then the fold fits, under the reaper."""
        def _task():
            hook = _CHAOS_HOOK
            action = hook(key, rung.index, attempt) if hook else None
            if action == "nan":
                return [float("nan")] * (hi - lo)
            return self.run_folds(self.first_index[key], self.params[key],
                                  lo, hi)
        budget = self._task_budget(hi - lo)
        if self.pool is not None and self.gang_task is not None:
            return self.pool.run_task(
                self.gang_task(self.params[key], lo, hi),
                budget_s=budget, op=f"automl.cand.{key[:8]}")
        if budget is None:
            return _task()
        return run_with_budget(_task, budget_s=budget,
                               op=f"automl.cand.{key[:8]}")

    def _finish(self, key: str, rung: RungSpec, lo: int,
                scores: Sequence[float], failed: str = "") -> None:
        with self._lock:
            held = self.state.fold_scores.setdefault(key, [])
            if len(held) != lo:     # stale double-completion guard
                return
            held.extend(float(s) for s in scores)
            if failed:
                self.state.failed[key] = failed
            done = failed or len(held) >= self.total_folds
            if done and key not in self.state.final:
                self.state.final[key] = self._mean(key)
                for hook in self._record_hooks:
                    hook(key, self.state.final[key], len(held))
            self._save()

    def _run_task(self, key: str, rung: RungSpec, lo: int, hi: int) -> None:
        attempt = self.state.attempts.get(key, 0)
        while True:
            with self._lock:
                self.state.attempts[key] = attempt
            t0 = time.monotonic()
            try:
                scores = self._execute(key, rung, lo, hi, attempt)
            except PeerLostError as e:
                # hung past the budget: reaped, never retried — the worker
                # thread is abandoned (daemon) and the slot is free
                record_failure("automl.candidate_hang", key=key,
                               rung=rung.index,
                               waited_s=round(e.waited_s, 3))
                self._finish(key, rung, lo, [float("nan")] * (hi - lo),
                             failed="hang")
                return
            except Exception as e:  # noqa: BLE001 — crash isolation
                attempt += 1
                if attempt < self.max_attempts:
                    record_failure("automl.candidate_retry", key=key,
                                   rung=rung.index, attempt=attempt,
                                   error=type(e).__name__)
                    continue
                # one broken candidate must not abort the search: score it
                # NaN (excluded by nanargmax/nanargmin) and keep going.
                # PreemptionError is a BaseException and still propagates.
                record_failure("automl.candidate_failure",
                               index=self.first_index[key],
                               error=type(e).__name__,
                               message=str(e)[:200])
                self._finish(key, rung, lo, [float("nan")] * (hi - lo),
                             failed="crash")
                return
            self._journal(hi - lo, time.monotonic() - t0, rung.index)
            self._finish(key, rung, lo, scores)
            return

    def _run_rung(self, rung: RungSpec, alive: List[str]) -> None:
        todo = []
        for key in alive:
            if key in self.state.final or key in self.state.failed:
                continue
            lo = len(self.state.fold_scores.get(key, []))
            if lo < rung.resource:
                todo.append((key, lo, rung.resource))
        if not todo:
            return
        preempt: Optional[BaseException] = None
        with ThreadPoolExecutor(max_workers=self.parallelism) as ex:
            futs = [ex.submit(self._run_task, key, rung, lo, hi)
                    for key, lo, hi in todo]
            for fut in futs:
                try:
                    fut.result()
                except BaseException as e:  # noqa: BLE001 — PreemptionError
                    # drain the rung's siblings (the with-block joins them)
                    # so their fold scores are checkpointed, THEN re-raise:
                    # the resume recomputes only the truly unfinished work
                    if preempt is None:
                        preempt = e
        if preempt is not None:
            raise preempt

    # -- barriers ----------------------------------------------------------
    def _ranked(self, alive: List[str]) -> List[str]:
        """Non-NaN candidates ranked best-first; index breaks ties. This is
        the single deterministic ordering every promotion derives from."""
        ok = [(k, self._mean(k)) for k in alive
              if not math.isnan(self._mean(k))]
        ok.sort(key=lambda ks: (-ks[1] if self.maximize else ks[1],
                                self.first_index[ks[0]]))
        return [k for k, _ in ok]

    def _quota(self, nxt: RungSpec) -> int:
        """Promotion quota: the ladder's count, optionally trimmed so the
        next rung's PREDICTED cost fits ``rung_time_budget_s`` — this is the
        perfmodel pricing the promotion decision (never below one)."""
        quota = nxt.survivors
        if self.rung_time_budget_s is None:
            return quota
        prev = 0 if nxt.index == 0 else self.rungs[nxt.index - 1].resource
        pred = self._predicted_chunk_s(nxt.resource - prev)
        if pred.confidence >= _PRICE_MIN_CONFIDENCE and \
                math.isfinite(pred.seconds) and pred.seconds > 0:
            affordable = int(self.rung_time_budget_s // pred.seconds)
            quota = max(1, min(quota, affordable))
        return quota

    def _promote(self, rung: RungSpec, alive: List[str],
                 nxt: RungSpec) -> List[str]:
        keep = self._ranked(alive)[: self._quota(nxt)]
        keep.sort(key=lambda k: self.first_index[k])
        with self._lock:
            self.state.promoted[str(rung.index)] = keep
            # elimination is terminal: the candidate's partial-fold mean is
            # its final metric, journaled like any completed candidate
            for k in alive:
                if k not in keep and k not in self.state.final:
                    self.state.final[k] = self._mean(k)
                    for hook in self._record_hooks:
                        hook(k, self.state.final[k],
                             len(self.state.fold_scores.get(k, [])))
            self.state.rung = rung.index + 1
            self._save()
        return keep

    def _finalize(self, rung: RungSpec, alive: List[str]) -> None:
        with self._lock:
            self.state.promoted[str(rung.index)] = self._ranked(alive)
            self.state.rung = rung.index + 1
            self._save()

    # -- the bracket's run loop -------------------------------------------
    def run(self) -> Dict[str, Dict[str, float]]:
        """Execute (or resume) the bracket; returns :meth:`results`."""
        alive = list(self.order)
        for i, rung in enumerate(self.rungs):
            # execution always runs (it is a no-op when every alive
            # candidate already holds this rung's folds) so an invalidated
            # resume record heals by recomputation even inside rungs whose
            # barrier was crossed in a previous life
            self._run_rung(rung, alive)
            if self.state.rung > i:
                # barrier already crossed: REPLAY the recorded decision —
                # resumes never re-litigate promotions
                alive = [k for k in self.state.promoted.get(str(i), alive)
                         if k in self.params]
                continue
            if i + 1 < len(self.rungs):
                alive = self._promote(rung, alive, self.rungs[i + 1])
            else:
                self._finalize(rung, alive)
        return self.results()


# ------------------------------------------------------------------ gang pool

class GangCandidatePool:
    """Candidate tasks on a ``TrainingSupervisor`` gang of spool workers.

    The pool writes ``task_<id>.json`` files into a spool directory; each
    ``automl/worker.py`` process claims one by atomic rename, runs its
    importable entry point, and writes ``result_<id>.json``. Failure
    handling maps onto the scheduler's model exactly:

    * worker crash (or ``kill_rank``) while holding a task → the supervisor
      respawns the rank and the pool re-spools the orphaned task, raising
      nothing (transparent respawn) unless the per-task respawn budget is
      exhausted, at which point the task raises ``RuntimeError`` → the
      scheduler counts a crash;
    * no result within ``budget_s`` → ``PeerLostError`` → the scheduler
      reaps the candidate as hung.

    Entries must be importable (``"pkg.mod:fn"``) — arbitrary closures do
    not cross process boundaries, which is why tune.py defaults to the
    in-process pool and the gang path is opt-in.
    """

    def __init__(self, world_size: int = 2, spool_dir: Optional[str] = None,
                 max_respawns: int = 2, hb_timeout: float = 5.0,
                 poll: float = 0.05, env: Optional[Dict[str, str]] = None):
        import os
        import subprocess
        import sys
        import tempfile

        from ..parallel.elastic import TrainingSupervisor

        self.spool = spool_dir or tempfile.mkdtemp(prefix="automl_spool_")
        os.makedirs(self.spool, exist_ok=True)
        self.poll = float(poll)
        self._ids = 0
        self._lock = threading.Lock()
        self._env = dict(env or {})

        # the workers import this package from the checkout it runs from
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))

        def _spawn(rank: int, world: int, attempt: int):
            e = dict(os.environ)
            pp = e.get("PYTHONPATH", "")
            e["PYTHONPATH"] = root + (os.pathsep + pp if pp else "")
            e.update(self._env)
            # pre-beat from the parent: a missing heartbeat file reads as
            # stale, so without this a freshly-spawned (still importing)
            # worker would be respawned on the very first supervisor step
            from ..core.checkpoint import atomic_write_text
            atomic_write_text(
                os.path.join(self.spool, f"hb_p{rank}.json"),
                json.dumps({"rank": rank, "op": "spawning", "step": 0,
                            "seq": 0, "pid": 0}))
            return subprocess.Popen(
                [sys.executable, "-m", "synapseml_tpu_torch.automl.worker",
                 "--spool", self.spool, "--rank", str(rank)], env=e)

        self.supervisor = TrainingSupervisor(
            _spawn, world_size=world_size, heartbeat_dir=self.spool,
            min_world=1, hb_timeout=hb_timeout, max_respawns=max_respawns,
            interval=poll).start_gang()

    def _next_id(self) -> str:
        with self._lock:
            self._ids += 1
            return f"{self._ids:06d}"

    def run_task(self, task: Dict[str, Any], budget_s: Optional[float] = None,
                 op: str = "gang_task", max_requeues: int = 2) -> Any:
        """Spool one ``{"entry": "pkg.mod:fn", "payload": {...}}`` task and
        block for its result, pumping the supervisor while waiting."""
        import os

        from ..core.checkpoint import atomic_write_text

        requeues = 0
        deadline = (time.monotonic() + budget_s) if budget_s else None
        tid = self._next_id()
        spec = json.dumps({"id": tid, **task}, default=repr)
        pending = os.path.join(self.spool, f"task_{tid}.json")
        result_fn = os.path.join(self.spool, f"result_{tid}.json")
        atomic_write_text(pending, spec)
        t0 = time.monotonic()
        while True:
            if os.path.exists(result_fn):
                with open(result_fn) as f:
                    rec = json.load(f)
                if rec.get("ok"):
                    return rec["value"]
                raise RuntimeError(f"gang task {tid} failed in worker: "
                                   f"{rec.get('error', '?')}")
            with self._lock:     # one pumper at a time
                self.supervisor.step()
            claim = self._claim_of(tid)
            if claim is not None and self._claimant_dead(*claim[1:]):
                # the claiming worker PROCESS died mid-task (claims are
                # keyed by pid — a respawned rank is a different claimant):
                # re-spool for the replacement unless this task has burned
                # its own respawn budget
                requeues += 1
                if requeues > max_requeues:
                    raise RuntimeError(
                        f"gang task {tid}: worker rank {claim[1]} died "
                        f"{requeues} times (respawn budget exhausted)")
                os.rename(os.path.join(self.spool, claim[0]), pending)
            if deadline is not None and time.monotonic() > deadline:
                raise PeerLostError(op, [], time.monotonic() - t0,
                                    detail=f"gang task {tid} produced no "
                                           f"result within {budget_s}s")
            time.sleep(self.poll)

    def _claim_of(self, tid: str):
        """(claim filename, rank, pid) when some worker holds this task."""
        import os

        for fn in sorted(os.listdir(self.spool)):
            if fn.startswith(f"task_{tid}.claimed.r"):
                try:
                    rank_s, pid_s = fn.rsplit(".r", 1)[1].split(".p")
                    return fn, int(rank_s), int(pid_s)
                except ValueError:
                    return None
        return None

    def _claimant_dead(self, rank: int, pid: int) -> bool:
        proc = self.supervisor.procs.get(rank)
        if proc is None or proc.poll() is not None:
            return True
        return proc.pid != pid   # a respawned rank is not the claimant

    def close(self) -> None:
        """Stop the workers (stop file) and reap them (idempotent)."""
        import os

        from ..core.checkpoint import atomic_write_text

        atomic_write_text(os.path.join(self.spool, "stop"), "stop")
        self.supervisor.retire()

    def __enter__(self) -> "GangCandidatePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
