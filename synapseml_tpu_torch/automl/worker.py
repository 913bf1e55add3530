"""Spool worker for :class:`automl.scheduler.GangCandidatePool`.

One process per gang rank, launched by the pool's ``TrainingSupervisor`` as
``python -m synapseml_tpu_torch.automl.worker --spool DIR --rank R``.
Protocol,
all through atomically-renamed files in the spool directory:

* the pool writes ``task_<id>.json`` — ``{"id", "entry": "pkg.mod:fn",
  "payload": {...}}``;
* a worker CLAIMS a task by renaming it to
  ``task_<id>.claimed.r<rank>.p<pid>`` (rename is atomic: exactly one
  claimant; the pid keys the claim to this process so a respawned rank is a
  different claimant and the pool re-spools the orphan);
* the worker resolves ``entry`` by import, runs ``fn(**payload)`` and writes
  ``result_<id>.json`` — ``{"id", "ok": true, "value": ...}`` or
  ``{"ok": false, "error": ...}`` (the *task* failing is a result; only the
  worker dying is a crash);
* a ``stop`` file in the spool shuts every worker down.

Liveness is the standard ``hb_p<rank>.json`` heartbeat
(``parallel.elastic.HeartbeatWriter`` on a background beater), so a hung
entry point is indistinguishable from a dead worker to the supervisor —
exactly the failure model the scheduler's reaper expects.

The port's copy of the JAX package's ``automl/worker.py`` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import time
import traceback


def _resolve(entry: str):
    mod, _, fn = entry.partition(":")
    if not mod or not fn:
        raise ValueError(f"entry must be 'pkg.mod:fn', got {entry!r}")
    return getattr(importlib.import_module(mod), fn)


def _claim(spool: str, fn: str, rank: int) -> str | None:
    src = os.path.join(spool, fn)
    dst = os.path.join(spool, f"{fn[:-len('.json')]}.claimed"
                              f".r{rank}.p{os.getpid()}")
    try:
        os.rename(src, dst)
        return dst
    except OSError:
        return None        # another rank won the rename race


def run_worker(spool: str, rank: int, poll: float = 0.05,
               max_tasks: int | None = None) -> int:
    """Poll-claim-run loop; returns the number of tasks completed."""
    from ..core.checkpoint import atomic_write_text
    from ..parallel.elastic import HeartbeatWriter

    done = 0
    with HeartbeatWriter(spool, rank, interval=0.25) as hb:
        while max_tasks is None or done < max_tasks:
            if os.path.exists(os.path.join(spool, "stop")):
                break
            claimed = None
            for fn in sorted(os.listdir(spool)):
                if fn.startswith("task_") and fn.endswith(".json"):
                    claimed = _claim(spool, fn, rank)
                    if claimed:
                        break
            if not claimed:
                time.sleep(poll)
                continue
            with open(claimed) as f:
                spec = json.load(f)
            tid = spec["id"]
            hb.beat(f"task_{tid}")
            try:
                value = _resolve(spec["entry"])(**spec.get("payload", {}))
                rec = {"id": tid, "ok": True, "value": value}
            except Exception:  # noqa: BLE001 — a failed task is a result
                rec = {"id": tid, "ok": False,
                       "error": traceback.format_exc(limit=8)}
            atomic_write_text(os.path.join(spool, f"result_{tid}.json"),
                              json.dumps(rec, default=repr))
            os.remove(claimed)
            done += 1
            hb.beat("idle")
    return done


def _echo(value=None, sleep_s: float = 0.0, crash: bool = False):
    """Importable self-test entry point
    ("synapseml_tpu_torch.automl.worker:_echo")
    for the gang protocol tests: optionally sleeps (hang/kill windows),
    optionally raises (failed-task-is-a-result path), else echoes."""
    if sleep_s:
        time.sleep(float(sleep_s))
    if crash:
        raise RuntimeError("deliberate _echo crash")
    return value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--spool", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--poll", type=float, default=0.05)
    args = ap.parse_args(argv)
    run_worker(args.spool, args.rank, poll=args.poll)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
