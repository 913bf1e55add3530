"""The port's online-learning loop on the CPU: the scenarios of the JAX
package's online suite, run on the port alone against its chaos copies:

* FeedbackLog bounding/dedup/quarantine — delayed, duplicated, NaN, and
  adversarial rewards never reach the learner, overflow sheds oldest-first
  and never blocks;
* chaos_reward_stream determinism + conservation (no silent drops);
* OnlineLearnerLoop learns from propensity-logged traffic, snapshots on
  cadence, and kill-mid-update → restore → replay is bit-for-bit equal to
  the uninterrupted run (corrupt newest snapshot falls back);
* StreamingAnomalyLoop flags outliers with a causally-adaptive threshold
  and has the same kill→resume equivalence (scored by a numpy function of
  the events; the isolation-forest and access-anomaly adapters refuse by
  name until those detectors are ported);
* PromotionGate promotes only interval-clears-incumbent candidates,
  survives a kill mid-promotion with the incumbent serving, and rolls back
  a live-reward regression;
* TestChaosInvariant — the end-to-end property: every accepted prediction
  request is answered by a gate-approved, never-regressed policy version,
  under the full battery at once.

Everything is scripted or seeded — reruns see the same fault sequence;
waits poll a condition with a deadline.
"""

from __future__ import annotations

import dataclasses
import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from synapseml_tpu_torch.core.checkpoint import (CheckpointStore,
                                                 PreemptionError)
from synapseml_tpu_torch.io.serving import ModelRegistry, ServingServer
from synapseml_tpu_torch.online import (AnomalyEvent, FeedbackEvent,
                                        FeedbackLog, GreedyPolicy,
                                        OnlineLearnerLoop, PromotionGate,
                                        StreamLoop, StreamingAnomalyLoop,
                                        access_anomaly_stream_scorer,
                                        anomaly_feedback_log,
                                        iforest_stream_scorer,
                                        make_policy_handler, policy_builder)
from synapseml_tpu_torch.testing import (ChaosPreemption, ChaosSwap,
                                         bit_flip, chaos_reward_stream)
from synapseml_tpu_torch.vw.learner import VWConfig, make_sparse_batch

from torch_fabric import wait_for
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"

CFG = VWConfig(num_bits=10, batch_size=8, learning_rate=0.5)
K = 3          # actions per decision
BEST = 2       # action with the high reward


def _featurize(_v=None):
    """Fixed 3-action candidate set (shared context folded in)."""
    return list(make_sparse_batch([[a * 7 + 1, a * 7 + 2] for a in range(K)],
                                  [[1.0, 1.0]] * K, pad_to=4))


def _reward(action: int) -> float:
    return 0.9 if action == BEST else 0.1


def _events(n, seed=0, policy=None):
    """n logged interactions; uniform logging unless a policy chooses."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        acts = _featurize()
        if policy is None:
            a, p = int(rng.integers(1, K + 1)), 1.0 / K
        else:
            a, p = policy.choose(acts)
        out.append(FeedbackEvent(key=f"e{seed}.{i}", actions=acts, action=a,
                                 probability=p, reward=_reward(a)))
    return out


def _fill(log, events):
    return [log.offer(ev) for ev in events]


# ---------------------------------------------------------------------------
# FeedbackLog
# ---------------------------------------------------------------------------

class TestFeedbackLog:
    def test_accept_and_fifo_drain(self):
        log = FeedbackLog(capacity=100)
        evs = _events(10)
        assert _fill(log, evs) == ["accepted"] * 10
        assert len(log) == 10
        got = log.drain(4)
        assert [e.key for e in got] == [e.key for e in evs[:4]]
        assert [e.key for e in log.drain(100)] == [e.key for e in evs[4:]]
        assert log.drain(5) == []

    def test_duplicates_dropped_once(self):
        log = FeedbackLog()
        ev = _events(1)[0]
        assert log.offer(ev) == "accepted"
        assert log.offer(ev) == "duplicate"
        assert log.offer(dataclasses.replace(ev, reward=0.5)) == "duplicate"
        assert len(log) == 1 and log.duplicates == 2

    def test_quarantine_reasons(self):
        log = FeedbackLog(reward_min=0.0, reward_max=1.0)
        ok = _events(1)[0]
        cases = {
            "nonfinite_reward": dataclasses.replace(ok, reward=float("nan")),
            "reward_out_of_range": dataclasses.replace(ok, reward=1e9),
            "bad_propensity": dataclasses.replace(ok, probability=0.0),
            "bad_action": dataclasses.replace(ok, action=K + 1),
        }
        for reason, ev in cases.items():
            assert log.offer(ev) == "quarantined", reason
        malformed = FeedbackEvent(key="m", actions=_featurize(), action=1,
                                  probability=0.5, reward="not-a-number")
        assert log.offer(malformed) == "quarantined"
        no_actions = FeedbackEvent(key="n", actions=[], action=1,
                                   probability=0.5, reward=0.5)
        assert log.offer(no_actions) == "quarantined"
        snap = log.snapshot()
        assert len(log) == 0 and snap["accepted"] == 0
        for reason in cases:
            assert snap["quarantined"][reason] >= 1
        assert snap["quarantined"]["malformed"] == 1

    def test_overflow_sheds_oldest_never_blocks(self):
        log = FeedbackLog(capacity=5)
        evs = _events(12)
        for ev in evs:
            assert log.offer(ev) == "accepted"   # returns immediately
        assert len(log) == 5 and log.shed_oldest == 7
        # the five NEWEST survived
        assert [e.key for e in log.drain(99)] == [e.key for e in evs[-5:]]

    def test_dedup_window_is_bounded(self):
        log = FeedbackLog(capacity=1000, dedup_window=4)
        evs = _events(6)
        _fill(log, evs)
        # the first key has been evicted from the dedup LRU: re-offer passes
        assert log.offer(evs[0]) == "accepted"
        assert log.offer(evs[-1]) == "duplicate"   # still in the window


# ---------------------------------------------------------------------------
# chaos_reward_stream
# ---------------------------------------------------------------------------

class TestChaosRewardStream:
    RATES = dict(delay_rate=0.2, dup_rate=0.15, nan_rate=0.1,
                 adversarial_rate=0.1)

    def test_deterministic_per_seed(self):
        evs = _events(60)
        a = [(e.key, repr(e.reward)) for e in
             chaos_reward_stream(evs, seed=3, **self.RATES)]
        b = [(e.key, repr(e.reward)) for e in
             chaos_reward_stream(evs, seed=3, **self.RATES)]
        c = [(e.key, repr(e.reward)) for e in
             chaos_reward_stream(evs, seed=4, **self.RATES)]
        assert a == b
        assert a != c

    def test_conservation_no_silent_drops(self):
        evs = _events(100)
        stream = chaos_reward_stream(evs, seed=1, **self.RATES)
        got = list(stream)
        # every input key emitted at least once, duplicates on top
        assert {e.key for e in got} == {e.key for e in evs}
        assert len(got) == len(evs) + stream.duplicated
        assert stream.delayed > 0 and stream.duplicated > 0
        assert stream.nans > 0 and stream.adversarial > 0

    def test_log_absorbs_corrupted_stream(self):
        evs = _events(150)
        stream = chaos_reward_stream(evs, seed=2, **self.RATES)
        log = FeedbackLog(capacity=10_000)
        verdicts = [log.offer(e) for e in stream]
        snap = log.snapshot()
        # accounting closes: every emitted event is accepted, deduped, or
        # quarantined — nothing vanishes
        assert len(verdicts) == snap["accepted"] + snap["duplicates"] \
            + sum(snap["quarantined"].values())
        assert snap["quarantined"].get("nonfinite_reward", 0) >= stream.nans
        assert snap["quarantined"].get("reward_out_of_range", 0) \
            >= stream.adversarial
        # only clean events reached the queue, each exactly once
        drained = log.drain(10_000)
        assert len(drained) == len({e.key for e in drained})
        assert all(math.isfinite(e.reward) and 0 <= e.reward <= 1
                   for e in drained)


# ---------------------------------------------------------------------------
# OnlineLearnerLoop
# ---------------------------------------------------------------------------

class TestOnlineLearnerLoop:
    def test_learns_best_action_from_uniform_logs(self):
        log = FeedbackLog(capacity=10_000)
        _fill(log, _events(256, seed=5))
        loop = OnlineLearnerLoop(log, CFG, device=CPU)
        assert loop.run_until_drained() == 256 // CFG.batch_size
        scores = GreedyPolicy(loop.state, CFG).scores(_featurize())
        assert int(np.argmax(scores)) == BEST - 1
        assert scores[BEST - 1] > 0.5 > scores[0]

    def test_snapshot_cadence_and_meta(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep_last=10)
        log = FeedbackLog(capacity=10_000)
        _fill(log, _events(64, seed=6))
        loop = OnlineLearnerLoop(log, CFG, store=store, snapshot_every=2,
                                 device=CPU)
        loop.run_until_drained()
        assert loop.last_snapshot_base == "ckpt_00000008"
        ckpt = store.load_latest()
        assert ckpt.meta["updates"] == 8 and ckpt.meta["events_seen"] == 64

    def test_kill_mid_update_resume_bit_for_bit(self, tmp_path):
        evs = _events(64, seed=7)
        # reference: uninterrupted run
        ref_log = FeedbackLog(capacity=10_000)
        _fill(ref_log, evs)
        ref = OnlineLearnerLoop(ref_log, CFG, device=CPU)
        ref.run_until_drained()
        # chaos run: die entering update 5 (snapshots at 2 and 4 exist)
        store = CheckpointStore(str(tmp_path), keep_last=5)
        log = FeedbackLog(capacity=10_000)
        _fill(log, evs)
        loop = OnlineLearnerLoop(log, CFG, store=store, snapshot_every=2,
                                 device=CPU)
        with pytest.raises(PreemptionError):
            with ChaosPreemption(at={"online.update": [4]}):
                loop.run_until_drained()
        # resume: restore newest snapshot, replay from its event offset
        resumed = OnlineLearnerLoop(FeedbackLog(capacity=10_000), CFG,
                                    store=store, snapshot_every=2, device=CPU)
        assert resumed.restore_latest()
        assert resumed.updates == 4 and resumed.events_seen == 32
        _fill(resumed.log, evs[resumed.events_seen:])
        resumed.run_until_drained()
        assert resumed.updates == ref.updates
        for f in ("weights", "acc", "bias", "bias_acc"):
            np.testing.assert_array_equal(
                np.asarray(getattr(resumed.state, f)),
                np.asarray(getattr(ref.state, f)), err_msg=f)

    def test_corrupt_newest_snapshot_falls_back(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep_last=5)
        log = FeedbackLog(capacity=10_000)
        _fill(log, _events(64, seed=8))
        loop = OnlineLearnerLoop(log, CFG, store=store, snapshot_every=2,
                                 device=CPU)
        loop.run_until_drained()
        bit_flip(str(tmp_path))   # corrupt the newest snapshot's artifact
        resumed = OnlineLearnerLoop(FeedbackLog(), CFG, store=store,
                                    device=CPU)
        assert resumed.restore_latest()
        assert resumed.updates == 6    # fell back past the corrupted 8

    def test_config_mismatch_refuses_restore(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep_last=3)
        log = FeedbackLog()
        _fill(log, _events(8, seed=9))
        OnlineLearnerLoop(log, CFG, store=store,
                          snapshot_every=1, device=CPU).run_until_drained()
        other = dataclasses.replace(CFG, learning_rate=0.01)
        bad = OnlineLearnerLoop(FeedbackLog(), other, store=store,
                                device=CPU)
        with pytest.raises(ValueError, match="different learner config"):
            bad.restore_latest()

    def test_background_thread_drains_and_joins_on_close(self):
        log = FeedbackLog(capacity=10_000)
        loop = OnlineLearnerLoop(log, CFG, drain_interval=0.005, device=CPU)
        with loop:
            _fill(log, _events(64, seed=10))
            wait_for(lambda: loop.events_seen >= 64, what="the drain")
        assert loop.events_seen == 64
        assert loop._thread is None        # close() joined the drain thread

    def test_background_thread_survives_poisoned_update(self):
        class Exploding(StreamLoop):
            def _update(self, events):
                raise RuntimeError("poisoned batch")

        log = FeedbackLog(capacity=100)
        _fill(log, _events(4, seed=11))
        loop = Exploding(log, batch_size=1, drain_interval=0.005)
        with loop:
            wait_for(lambda: not len(log), what="the drain")
            wait_for(lambda: loop.errors == 4, what="the errors' count")
        assert loop.errors == 4 and loop.updates == 0   # logged, not dead


# ---------------------------------------------------------------------------
# Streaming anomaly
# ---------------------------------------------------------------------------

def distance_scorer(X):
    """A numpy scorer of dense-feature events (the streaming loop takes any
    function of a micro-batch): each event's distance from the mean of
    ``X``, in float64. The isolation forest is not ported; the JAX
    package's loop is given the same function."""
    center = np.asarray(X, np.float64).mean(axis=0)

    def score(events):
        F = np.stack([np.asarray(ev.features, np.float64) for ev in events])
        return np.sqrt(((F - center) ** 2).sum(axis=1))

    return score


def _scored_model(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(256, 4))
    return distance_scorer(X), X


class TestStreamingAnomaly:
    def test_flags_outliers_threshold_adapts(self):
        scorer, X = _scored_model()
        log = anomaly_feedback_log()
        for i in range(64):                       # warmup: inliers only
            log.offer(AnomalyEvent(key=f"in{i}", features=X[i]))
        loop = StreamingAnomalyLoop(log, scorer,
                                    batch_size=16, window=64, min_window=32,
                                    contamination=0.05)
        loop.run_until_drained()
        warm_flagged = loop.flagged
        assert math.isfinite(loop.threshold)
        for i in range(8):                        # now far-out outliers
            log.offer(AnomalyEvent(key=f"out{i}",
                                   features=np.full(4, 9.0) + i))
        loop.run_until_drained()
        assert loop.flagged >= warm_flagged + 8   # every outlier flagged
        assert loop.scored == 72

    def test_cold_window_never_flags(self):
        scorer, X = _scored_model()
        log = anomaly_feedback_log()
        for i in range(8):
            log.offer(AnomalyEvent(key=f"o{i}", features=np.full(4, 9.0)))
        loop = StreamingAnomalyLoop(log, scorer,
                                    batch_size=4, min_window=32)
        loop.run_until_drained()
        assert loop.flagged == 0 and loop.threshold == math.inf

    def test_nonfinite_features_quarantined(self):
        log = anomaly_feedback_log()
        assert log.offer(AnomalyEvent(
            key="nan", features=np.array([1.0, float("nan")]))) \
            == "quarantined"
        assert log.offer(AnomalyEvent(key="none", features=None)) \
            == "quarantined"
        assert log.snapshot()["quarantined"] == {"nonfinite_features": 1,
                                                 "malformed": 1}

    def test_kill_mid_scoring_resume_bit_for_bit(self, tmp_path):
        scorer, X = _scored_model(seed=1)
        feed = [AnomalyEvent(key=f"s{i}", features=X[i % 256] * (1 + i / 64))
                for i in range(128)]

        def fresh(store=None):
            log = anomaly_feedback_log(capacity=10_000)
            return StreamingAnomalyLoop(
                log, scorer, store=store,
                batch_size=16, window=64, min_window=16,
                contamination=0.1, snapshot_every=2)

        ref = fresh()
        for ev in feed:
            ref.log.offer(ev)
        ref.run_until_drained()

        store = CheckpointStore(str(tmp_path), keep_last=5)
        loop = fresh(store)
        for ev in feed:
            loop.log.offer(ev)
        with pytest.raises(PreemptionError):
            with ChaosPreemption(at={"online.anomaly": [5]}):
                loop.run_until_drained()
        resumed = fresh(store)
        assert resumed.restore_latest()
        assert resumed.updates == 4
        for ev in feed[resumed.events_seen:]:
            resumed.log.offer(ev)
        resumed.run_until_drained()
        assert resumed.threshold == ref.threshold
        assert resumed.flagged == ref.flagged and resumed.scored == ref.scored
        np.testing.assert_array_equal(np.asarray(resumed._scores),
                                      np.asarray(ref._scores))

    @pytest.mark.parametrize("adapter,needs", [
        (iforest_stream_scorer, "isolationforest"),
        (access_anomaly_stream_scorer, "cyber")])
    def test_unported_scorer_adapters_refuse_by_name(self, adapter, needs):
        with pytest.raises(NotImplementedError, match=adapter.__name__) as e:
            adapter(object())
        assert needs in str(e.value)


# ---------------------------------------------------------------------------
# PromotionGate
# ---------------------------------------------------------------------------

def _serving_stack():
    """(registry, gate) around an unstarted server serving the uniform
    incumbent v0 — swap/rollback semantics are fully exercised without TCP."""
    from synapseml_tpu_torch.vw.learner import VWState
    incumbent = GreedyPolicy(VWState.init(CFG.num_bits, CPU), CFG, epsilon=1.0,
                             seed=0, version="v0")
    srv = ServingServer(make_policy_handler(incumbent, _featurize))
    reg = ModelRegistry(srv, version="v0")
    gate = PromotionGate(reg, min_samples=50, regression_window=10,
                         regression_tolerance=0.05)
    return incumbent, reg, gate


def _trained_store(tmp_path, gate=None, n=256, seed=12):
    """Train a candidate into a CheckpointStore off uniform logged traffic,
    feeding the same events to the gate as evidence."""
    store = CheckpointStore(str(tmp_path), keep_last=4)
    log = FeedbackLog(capacity=10_000)
    loop = OnlineLearnerLoop(log, CFG, store=store, snapshot_every=4,
                             device=CPU)
    for ev in _events(n, seed=seed):
        if log.offer(ev) == "accepted" and gate is not None:
            gate.record(ev)
    loop.run_until_drained()
    return store


class TestPromotionGate:
    def test_insufficient_samples_refuses(self, tmp_path):
        _, reg, gate = _serving_stack()
        store = _trained_store(tmp_path)     # no evidence recorded
        dec = gate.try_promote(store, policy_builder(CFG, _featurize, device=CPU))
        assert not dec.promoted and dec.reason == "insufficient_samples"
        assert reg.active == "v0"

    def test_promotes_interval_clearing_candidate(self, tmp_path):
        _, reg, gate = _serving_stack()
        store = _trained_store(tmp_path, gate)
        dec = gate.try_promote(store, policy_builder(CFG, _featurize, device=CPU))
        assert dec.promoted and dec.reason == "interval_clears_incumbent"
        assert dec.interval[0] > dec.incumbent_value
        assert abs(dec.incumbent_value - (0.9 + 2 * 0.1) / 3) < 0.1
        assert reg.active == dec.candidate_version != "v0"
        assert reg.active in gate.approved_versions

    def test_refuses_no_better_candidate(self, tmp_path):
        _, reg, gate = _serving_stack()
        # evidence where EVERY action pays the same: no candidate can beat
        # the incumbent's logged mean
        log = FeedbackLog(capacity=10_000)
        store = CheckpointStore(str(tmp_path), keep_last=4)
        loop = OnlineLearnerLoop(log, CFG, store=store, snapshot_every=4,
                             device=CPU)
        for ev in _events(256, seed=13):
            flat = dataclasses.replace(ev, reward=0.5)
            if log.offer(flat) == "accepted":
                gate.record(flat)
        loop.run_until_drained()
        dec = gate.try_promote(store, policy_builder(CFG, _featurize, device=CPU))
        assert not dec.promoted
        assert dec.reason == "interval_overlaps_incumbent"
        assert reg.active == "v0"

    def test_kill_mid_promotion_keeps_incumbent(self, tmp_path):
        _, reg, gate = _serving_stack()
        store = _trained_store(tmp_path, gate)
        with ChaosSwap(at="flip") as cs:
            dec = gate.try_promote(store, policy_builder(CFG, _featurize, device=CPU))
        assert not dec.promoted and dec.reason == "swap_failed"
        assert len(cs.kills) == 1
        assert reg.active == "v0" and reg.swap_failures == 1
        assert gate.approved_versions == {"v0"}
        # the chaos is one-shot: the retry goes through
        dec2 = gate.try_promote(store, policy_builder(CFG, _featurize, device=CPU))
        assert dec2.promoted and reg.active == dec2.candidate_version

    def test_empty_store_refuses(self, tmp_path):
        _, reg, gate = _serving_stack()
        store = CheckpointStore(str(tmp_path), keep_last=2)
        dec = gate.try_promote(store, policy_builder(CFG, _featurize, device=CPU))
        assert not dec.promoted and dec.reason == "no_verifiable_checkpoint"
        assert reg.active == "v0"

    def test_live_regression_rolls_back(self, tmp_path):
        _, reg, gate = _serving_stack()
        store = _trained_store(tmp_path, gate)
        dec = gate.try_promote(store, policy_builder(CFG, _featurize, device=CPU))
        assert dec.promoted
        rolled = False
        for _ in range(gate.regression_window):
            rolled = gate.observe_live(0.0) or rolled
        assert rolled and gate.rollbacks == 1
        assert reg.active == "v0"              # back on the prior approved
        assert not gate.snapshot()["watchdog_armed"]

    def test_healthy_live_reward_disarms_watchdog(self, tmp_path):
        _, reg, gate = _serving_stack()
        store = _trained_store(tmp_path, gate)
        dec = gate.try_promote(store, policy_builder(CFG, _featurize, device=CPU))
        assert dec.promoted
        for _ in range(gate.regression_window):
            assert not gate.observe_live(0.9)
        assert reg.active == dec.candidate_version
        assert gate.rollbacks == 0
        assert not gate.snapshot()["watchdog_armed"]


# ---------------------------------------------------------------------------
# The end-to-end chaos invariant
# ---------------------------------------------------------------------------

def _post(url, value, timeout=10.0):
    body = json.dumps(value).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, None


@pytest.mark.slow
class TestChaosInvariant:
    """Accepted prediction requests are ALWAYS answered by a promoted,
    never-regressed policy version — under kill-mid-update,
    kill-mid-promotion, a corrupted snapshot, and a delayed/duplicated/NaN/
    adversarial reward stream, all in one run."""

    def test_full_battery(self, tmp_path):
        from synapseml_tpu_torch.vw.learner import VWState
        incumbent = GreedyPolicy(VWState.init(CFG.num_bits, CPU), CFG,
                                 epsilon=1.0, seed=0, version="v0")
        srv = ServingServer(make_policy_handler(incumbent, _featurize),
                            port=0, max_batch_latency=0.0).start()
        served = []      # every (status, version) a client observed

        def ask(n=4):
            for _ in range(n):
                status, reply = _post(srv.url, {})
                if status == 200:
                    served.append(reply["version"])

        try:
            reg = ModelRegistry(srv, version="v0")
            gate = PromotionGate(reg, min_samples=100, regression_window=20,
                                 regression_tolerance=0.05)
            store = CheckpointStore(str(tmp_path), keep_last=5)
            log = FeedbackLog(capacity=10_000)
            loop = OnlineLearnerLoop(log, CFG, store=store, snapshot_every=2,
                                 device=CPU)

            # phase 1 — corrupted reward stream into the log while serving
            ask()
            stream = chaos_reward_stream(
                _events(320, seed=20), seed=21, delay_rate=0.15,
                dup_rate=0.1, nan_rate=0.1, adversarial_rate=0.1)
            for ev in stream:
                if log.offer(ev) == "accepted":
                    gate.record(ev)
            assert stream.nans > 0 and stream.adversarial > 0
            assert sum(log.snapshot()["quarantined"].values()) > 0

            # phase 2 — learner killed mid-update, restores, replays
            with pytest.raises(PreemptionError):
                with ChaosPreemption(at={"online.update": [6]}):
                    loop.run_until_drained()
            ask()
            leftover = log.drain(100_000)     # events the dead loop held
            loop = OnlineLearnerLoop(FeedbackLog(capacity=10_000), CFG,
                                     store=store, snapshot_every=2, device=CPU)
            assert loop.restore_latest() and loop.updates > 0
            for ev in leftover:
                loop.log.offer(ev)
            loop.run_until_drained()
            assert loop.updates >= 6

            # phase 3 — promotion killed mid-swap: incumbent keeps serving
            builder = policy_builder(CFG, _featurize, epsilon=0.05, seed=7,
                                     device=CPU)
            with ChaosSwap(at="flip"):
                dec = gate.try_promote(store, builder)
            assert not dec.promoted and dec.reason == "swap_failed"
            assert reg.active == "v0"
            ask()

            # phase 4 — newest snapshot corrupted: digest check falls back
            # to an older verified snapshot, promotion still succeeds
            bit_flip(str(tmp_path))
            dec = gate.try_promote(store, builder)
            assert dec.promoted, dec
            assert reg.active == dec.candidate_version
            ask()

            # phase 5 — live reward regresses: auto-rollback to v0
            for _ in range(gate.regression_window):
                gate.observe_live(0.0)
            assert gate.rollbacks == 1 and reg.active == "v0"
            ask()

            # THE invariant: every answered request came from a version the
            # gate approved (v0 or the promoted candidate), and the version
            # serving now is approved
            assert served and set(served) <= gate.approved_versions
            assert reg.active in gate.approved_versions
            # and the rollback target was itself approved (never-regressed)
            assert served[-1] == "v0"
        finally:
            srv.stop()
