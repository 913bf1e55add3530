"""The online-learning loop skeleton + the VW contextual-bandit learner loop
(the port's counterpart of the JAX package's ``online/loop.py``).

:class:`StreamLoop` is the shared drain→update→snapshot skeleton: a
background thread drains micro-batches from a
:class:`~synapseml_tpu_torch.online.feedback.FeedbackLog`, applies a model
update, and snapshots its state through a digest-verified
:class:`~synapseml_tpu_torch.core.checkpoint.CheckpointStore` every
``snapshot_every`` updates. Every update boundary is a
:func:`~synapseml_tpu_torch.core.checkpoint.preemption_point` (phase
``online.update`` / ``online.anomaly``), so the chaos machinery
(``ChaosPreemption``, ``torn_write``/``bit_flip``) applies unchanged and the
recovery contract is the one the offline trainers already prove:

    kill anywhere, restore the newest VERIFIED snapshot, replay the event
    stream from the snapshot's ``events_seen`` offset → bit-for-bit the
    uninterrupted run.

Replay determinism holds because every update is a pure function of
(state, micro-batch) with static shapes (``batch_size`` rows padded with
zero sample weights, feature width padded to ``pad_features``), so the same
events through the same boundaries produce the same bytes — on the CPU; on
the card the scatter-adds' atomics add repeated indices in no fixed order,
so a replay there matches to float32 roundoff. The micro-batch boundaries
themselves are part of the replayed stream contract: ``step()`` consumes
events in arrival order in fixed-size bites.

:class:`OnlineLearnerLoop` instantiates the skeleton for the contextual
bandit: IPS-weighted reward regression on the chosen action's hashed
features (``vw/learner.py``, on the loop's ``device``), snapshotting
``VWState`` through the store. ``online/anomaly.py`` reuses the identical
skeleton for streaming anomaly scoring.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Callable, List, Optional

import numpy as np

from ..core.checkpoint import CheckpointStore, preemption_point
from ..core.device import DEFAULT_DEVICE
from ..core.logging import record_failure
from .feedback import FeedbackLog
from ..vw.learner import VWConfig, VWState, train_vw


class StreamLoop:
    """Drain → update → snapshot skeleton shared by the bandit learner and
    the streaming anomaly scorers.

    Subclasses implement ``_update(events)``, ``_artifacts() -> dict`` and
    ``_restore(checkpoint) -> None``. Synchronous driving (``step()`` /
    ``run_until_drained()``) is the deterministic path the recovery tests
    replay; ``start()``/``close()`` run the same steps on a background
    thread for live serving — ``close()`` always joins the thread
    (resource-discipline: the drain thread may not outlive its owner)."""

    phase = "online.update"
    counter_prefix = "online.loop"

    def __init__(self, log: FeedbackLog, store: Optional[CheckpointStore] = None,
                 batch_size: int = 64, snapshot_every: int = 8,
                 drain_interval: float = 0.01,
                 on_snapshot: Optional[Callable[[int, str], None]] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}")
        self.log = log
        self.store = store
        self.batch_size = batch_size
        self.snapshot_every = snapshot_every
        self.drain_interval = drain_interval
        self.on_snapshot = on_snapshot
        self.updates = 0
        self.events_seen = 0
        self.errors = 0
        self.last_snapshot_base: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._step_lock = threading.Lock()   # one update at a time

    # -- subclass surface --
    def _update(self, events: List) -> None:
        raise NotImplementedError

    def _artifacts(self) -> dict:
        raise NotImplementedError

    def _restore(self, ckpt) -> None:
        raise NotImplementedError

    def _meta(self) -> dict:
        return {"updates": self.updates, "events_seen": self.events_seen}

    # -- synchronous driving (the deterministic replay surface) --
    def step(self) -> bool:
        """Drain one micro-batch and apply one update; returns False when
        the log had nothing. The preemption point fires BEFORE the drain, so
        an injected kill loses no event that an uninterrupted run would have
        consumed at this boundary."""
        with self._step_lock:
            preemption_point(self.phase, self.updates)
            events = self.log.drain(self.batch_size)
            if not events:
                return False
            self._update(events)
            self.updates += 1
            self.events_seen += len(events)
            if self.store is not None and \
                    self.updates % self.snapshot_every == 0:
                self.snapshot()
        return True

    def run_until_drained(self) -> int:
        """Synchronously step until the log is empty; returns updates run."""
        n = 0
        while self.step():
            n += 1
        return n

    # -- snapshot / restore --
    def snapshot(self) -> Optional[str]:
        """Persist current state as one atomic, digest-verified checkpoint
        (step = update count). No-op without a store."""
        if self.store is None:
            return None
        base = self.store.save(self.updates, self._artifacts(),
                               meta=self._meta())
        self.last_snapshot_base = base
        if self.on_snapshot is not None:
            self.on_snapshot(self.updates, base)
        return base

    def restore_latest(self) -> bool:
        """Restore the newest checkpoint that VERIFIES (corrupt snapshots
        fall back per the store contract). Returns False when the store is
        empty/absent — the loop then starts fresh."""
        if self.store is None:
            return False
        ckpt = self.store.load_latest()
        if ckpt is None:
            return False
        self._restore(ckpt)
        self.updates = int(ckpt.meta.get("updates", ckpt.step))
        self.events_seen = int(ckpt.meta.get("events_seen", 0))
        return True

    # -- background drive --
    def start(self) -> "StreamLoop":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("loop already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name=f"{self.counter_prefix}.drain",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        # the drain-poll skeleton lives in the shared ingestion layer
        # (io/ingest.py pump_polling — deliberately the POLLING shape, not a
        # lookahead pump: step()'s drain is destructive and must stay behind
        # its own preemption point). Exception → count + keep draining;
        # PreemptionError is BaseException and still kills the thread like a
        # real SIGTERM would.
        from ..io.ingest import pump_polling  # lazy: io/__init__ is heavy

        def on_error(e: Exception) -> None:
            self.errors += 1
            record_failure(f"{self.counter_prefix}.update_error",
                           error=type(e).__name__)

        pump_polling(self.step, self._stop, self.drain_interval,
                     on_error=on_error)

    def close(self, timeout: float = 5.0, final_snapshot: bool = False) -> None:
        """Stop and JOIN the drain thread, then optionally take one last
        snapshot of whatever the thread had applied. Idempotent."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None
        if final_snapshot and self.store is not None:
            with self._step_lock:
                self.snapshot()

    def __enter__(self) -> "StreamLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def snapshot_stats(self) -> dict:
        return {"updates": self.updates, "events_seen": self.events_seen,
                "errors": self.errors,
                "last_snapshot": self.last_snapshot_base,
                "log": self.log.snapshot()}


def _cfg_fingerprint(cfg: VWConfig) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


class OnlineLearnerLoop(StreamLoop):
    """Contextual-bandit online learner: micro-batched IPS-weighted reward
    regression on the chosen action's hashed features.

    Each update is one batch of the learner on ``device`` with static
    shapes: exactly ``batch_size`` rows (missing rows ride along with
    sample weight 0 — a mathematical no-op for loss, gradient, and adagrad
    accumulators) and a feature width padded to at least
    ``pad_features``.
    ``cfg.cb_type``: ``"ips"`` importance-weights each example by
    ``1/propensity`` (unbiased under the logging policy); ``"mtr"``
    regresses on the chosen action unweighted."""

    phase = "online.update"
    counter_prefix = "online.learner"

    def __init__(self, log: FeedbackLog, cfg: VWConfig,
                 store: Optional[CheckpointStore] = None,
                 initial_state: Optional[VWState] = None,
                 pad_features: int = 16, min_propensity: float = 1e-6,
                 device=DEFAULT_DEVICE, **kw):
        super().__init__(log, store=store,
                         batch_size=kw.pop("batch_size", cfg.batch_size), **kw)
        self.cfg = cfg
        self._train_cfg = dataclasses.replace(
            cfg, batch_size=self.batch_size, num_passes=1)
        self.device = device
        self.state = initial_state if initial_state is not None \
            else VWState.init(cfg.num_bits, device)
        self.pad_features = max(int(pad_features), 1)
        self.min_propensity = min_propensity

    def _update(self, events: List) -> None:
        b = self.batch_size
        rows = [np.asarray(ev.actions[int(ev.action) - 1]) for ev in events]
        p = max([self.pad_features] + [r.shape[-1] for r in rows])
        idx = np.zeros((b, p), np.int32)
        val = np.zeros((b, p), np.float32)
        y = np.zeros(b, np.float32)
        sw = np.zeros(b, np.float32)
        for i, (ev, r) in enumerate(zip(events, rows)):
            k = r.shape[-1]
            idx[i, :k] = r["idx"]
            val[i, :k] = r["val"]
            y[i] = float(ev.reward)
            sw[i] = (1.0 / max(float(ev.probability), self.min_propensity)
                     if self.cfg.cb_type == "ips" else 1.0)
        self.state, _ = train_vw(idx, val, y, self._train_cfg,
                                 sample_weight=sw,
                                 initial_state=self.state,
                                 device=self.device)

    # snapshots ride VWState's CheckpointStore round-trip (the same
    # digest-verified artifact path gbdt/dl/automl write through)
    def _artifacts(self) -> dict:
        return {VWState.STORE_ARTIFACT: self.state.to_bytes()}

    def _meta(self) -> dict:
        meta = super()._meta()
        meta["cfg_fingerprint"] = _cfg_fingerprint(self.cfg)
        return meta

    def _restore(self, ckpt) -> None:
        fp = ckpt.meta.get("cfg_fingerprint")
        if fp is not None and fp != _cfg_fingerprint(self.cfg):
            raise ValueError(
                f"checkpoint {ckpt.base} was written under a different "
                f"learner config (fingerprint {fp} != "
                f"{_cfg_fingerprint(self.cfg)}); refusing to resume a "
                "mismatched policy")
        data = ckpt.artifacts.get(VWState.STORE_ARTIFACT)
        if data is None:
            raise ValueError(
                f"checkpoint {ckpt.base} holds no "
                f"{VWState.STORE_ARTIFACT!r} artifact")
        self.state = VWState.from_bytes(data, self.device)

    def snapshot(self) -> Optional[str]:
        if self.store is None:
            return None
        base = self.state.save_to_store(self.store, self.updates,
                                        meta=self._meta())
        self.last_snapshot_base = base
        if self.on_snapshot is not None:
            self.on_snapshot(self.updates, base)
        return base

    def restore_latest(self) -> bool:
        if self.store is None:
            return False
        loaded = VWState.load_from_store(self.store, device=self.device)
        if loaded is None:
            return False
        state, ckpt = loaded
        self._restore(ckpt)          # fingerprint check; reparses cheaply
        self.state = state
        self.updates = int(ckpt.meta.get("updates", ckpt.step))
        self.events_seen = int(ckpt.meta.get("events_seen", 0))
        return True
