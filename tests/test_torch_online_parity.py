"""The port's online loop against the JAX package's, on the same event
stream (CPU):

* ``FeedbackLog`` decisions (accepted / duplicate / quarantined, the
  quarantine reasons, overflow, the drain order) on a seeded stream that
  ``chaos_reward_stream`` delays, duplicates and poisons: equal;
* ``GreedyPolicy`` actions and propensities from the same state and seed:
  equal (numpy's ``default_rng`` draws in both);
* ``OnlineLearnerLoop`` snapshots: the same checkpoint steps, metadata and
  kill/resume points, states within the learner's tolerance
  (``tests/test_torch_vw.py``'s ``W_TOL``);
* ``PromotionGate`` verdicts on the same evidence: equal decisions and
  reasons, estimates to float64 roundoff of the scores;
* ``StreamingAnomalyLoop`` with the same numpy scorer: equal scores,
  thresholds and flags.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from synapseml_tpu import online as jonline
from synapseml_tpu import testing as jtesting
from synapseml_tpu.core import checkpoint as jck
from synapseml_tpu.io import serving as jsv
from synapseml_tpu.vw import learner as jlearner

from synapseml_tpu_torch import online as tonline
from synapseml_tpu_torch import testing as ttesting
from synapseml_tpu_torch.convert import vw_state_arrays
from synapseml_tpu_torch.core import checkpoint as tck
from synapseml_tpu_torch.io import serving as tsv
from synapseml_tpu_torch.vw import learner as tlearner
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)

CPU = "cpu"
W_TOL = 1e-5
K = 3
PACKAGES = {"jax": (jonline, jtesting, jck, jsv, jlearner, {}),
            "torch": (tonline, ttesting, tck, tsv, tlearner,
                      {"device": CPU})}


def _featurize(learner, ctx=0.0):
    return list(learner.make_sparse_batch(
        [[a * 7 + 1, a * 7 + 2, 40 + a] for a in range(K)],
        [[1.0, 1.0, ctx]] * K, pad_to=4))


def _events(online, learner, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ctx = float(rng.normal())
        a = int(rng.integers(1, K + 1))
        best = 3 if ctx > 0 else 1
        out.append(online.FeedbackEvent(
            key=f"e{seed}.{i}", actions=_featurize(learner, ctx), action=a,
            probability=1.0 / K, reward=0.9 if a == best else 0.1))
    return out


def _feedback_run(online, testing, learner):
    stream = testing.chaos_reward_stream(
        _events(online, learner, 300, seed=1), seed=4, delay_rate=0.2,
        dup_rate=0.1, nan_rate=0.05, adversarial_rate=0.05)
    log = online.FeedbackLog(capacity=64, reward_min=0.0, reward_max=1.0)
    statuses, drained = [], []
    for i, ev in enumerate(stream):
        if i % 37 == 0:
            ev = dataclasses.replace(ev, probability=0.0)
        statuses.append((ev.key, log.offer(ev)))
        if i % 50 == 49:
            drained.append([e.key for e in log.drain(20)])
    drained.append([e.key for e in log.drain(1000)])
    return (statuses, drained, log.snapshot(), stream.delayed,
            stream.duplicated, stream.nans, stream.adversarial)


def test_feedback_log_decisions_match_the_reference():
    got = {name: _feedback_run(o, t, lr)
           for name, (o, t, _c, _s, lr, _kw) in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert {s for _, s in got["torch"][0]} >= {"accepted", "duplicate",
                                                "quarantined"}


def test_validate_bandit_event_matches_the_reference():
    for ev in _events(jonline, jlearner, 5, seed=2):
        for change in (dict(), dict(reward=float("inf")), dict(action=0),
                       dict(probability=1.5), dict(actions=[])):
            bad = dataclasses.replace(ev, **change)
            tev = tonline.FeedbackEvent(**dataclasses.asdict(bad))
            assert tonline.validate_bandit_event(tev, 0.0, 1.0) == \
                jonline.validate_bandit_event(bad, 0.0, 1.0)


def _loop_run(online, testing, ck, learner, kw, workdir, kill_at):
    """Train through a snapshotting loop, killed at update ``kill_at``
    and resumed from its newest verified snapshot; then a policy on the
    result chooses actions."""
    cfg = learner.VWConfig(num_bits=10, batch_size=16, learning_rate=0.5)
    events = _events(online, learner, 400, seed=3)
    store = ck.CheckpointStore(str(workdir), keep_last=4)
    loop = online.OnlineLearnerLoop(
        online.FeedbackLog(capacity=10_000), cfg, store=store,
        snapshot_every=3, **kw)
    for ev in events:
        loop.log.offer(ev)
    with pytest.raises(ck.PreemptionError):
        with testing.ChaosPreemption(at={"online.update": [kill_at]}):
            loop.run_until_drained()
    resumed = online.OnlineLearnerLoop(
        online.FeedbackLog(capacity=10_000), cfg, store=store,
        snapshot_every=3, **kw)
    assert resumed.restore_latest()
    at = (resumed.updates, resumed.events_seen)
    for ev in events[resumed.events_seen:]:
        resumed.log.offer(ev)
    resumed.run_until_drained()
    final = resumed.snapshot()
    ckpt = store.load_latest()
    policy = online.GreedyPolicy(resumed.state, cfg, epsilon=0.2, seed=11)
    rng = np.random.default_rng(5)
    contexts = [float(c) for c in rng.normal(size=60)]
    choices = [policy.choose(_featurize(learner, c)) for c in contexts]
    probs = [policy.action_probabilities(_featurize(learner, c)).tolist()
             for c in contexts]
    state = vw_state_arrays(resumed.state)
    meta = {k: v for k, v in ckpt.meta.items() if k != "cfg_fingerprint"}
    return dict(at=at, final=final, step=ckpt.step, meta=meta,
                stats=resumed.snapshot_stats()["log"], choices=choices,
                probs=probs, state=state)


@pytest.mark.parametrize("kill_at", [4, 10])
def test_learner_loop_snapshots_and_policy_match_the_reference(tmp_path,
                                                               kill_at):
    got = {name: _loop_run(o, t, c, lr, kw, tmp_path / name, kill_at)
           for name, (o, t, c, _s, lr, kw) in PACKAGES.items()}
    t, j = got["torch"], got["jax"]
    for key in ("at", "final", "step", "meta", "stats", "choices", "probs"):
        assert t[key] == j[key], key
    for k, v in j["state"].items():
        gap = np.abs(t["state"][k] - v).max() / max(np.abs(v).max(), 1.0)
        assert gap <= W_TOL, k


def _gate_run(online, ck, sv, learner, kw, workdir):
    cfg = learner.VWConfig(num_bits=10, batch_size=16, learning_rate=0.5)
    zero = learner.VWState.init(cfg.num_bits, **kw)
    incumbent = online.GreedyPolicy(zero, cfg, epsilon=1.0, seed=0,
                                    version="v0")
    featurize = lambda _v=None: _featurize(learner, 0.5)  # noqa: E731
    reg = sv.ModelRegistry(sv.ServingServer(
        online.make_policy_handler(incumbent, featurize)), version="v0")
    gate = online.PromotionGate(reg, min_samples=50, regression_window=10)
    store = ck.CheckpointStore(str(workdir), keep_last=4)
    log = online.FeedbackLog(capacity=10_000)
    loop = online.OnlineLearnerLoop(log, cfg, store=store, snapshot_every=4,
                                    **kw)
    out = []
    builder = online.policy_builder(cfg, featurize, **kw)
    for chunk in range(4):
        for ev in _events(online, learner, 40, seed=20 + chunk):
            if log.offer(ev) == "accepted":
                gate.record(ev)
        loop.run_until_drained()
        dec = gate.try_promote(store, builder)
        out.append((dec.promoted, dec.reason, dec.n_samples,
                    dec.incumbent_value, dec.snips, dec.interval))
    rolled = [gate.observe_live(r) for r in [0.0] * gate.regression_window]
    snap = gate.snapshot()
    return out, any(rolled), gate.rollbacks, gate.promotions, \
        {k: snap[k] for k in ("promotions", "rollbacks", "watchdog_armed")}


def test_promotion_gate_verdicts_match_the_reference(tmp_path):
    got = {name: _gate_run(o, c, s, lr, kw, tmp_path / name)
           for name, (o, _t, c, s, lr, kw) in PACKAGES.items()}
    (tdec, *trest), (jdec, *jrest) = got["torch"], got["jax"]
    assert trest == jrest
    assert [d[:3] for d in tdec] == [d[:3] for d in jdec]
    assert any(d[0] for d in tdec)              # a candidate was promoted
    for td, jd in zip(tdec, jdec):
        assert td[3] == jd[3]                   # the logged mean: exact
        np.testing.assert_allclose([td[4], *td[5]], [jd[4], *jd[5]],
                                   rtol=1e-9, atol=1e-12)


def _anomaly_run(online, testing, ck, workdir):
    rng = np.random.default_rng(6)
    X = rng.normal(size=(200, 4))
    center = X.mean(axis=0)

    def scorer(events):
        F = np.stack([np.asarray(ev.features, np.float64) for ev in events])
        return np.sqrt(((F - center) ** 2).sum(axis=1))

    feed = [online.AnomalyEvent(key=f"a{i}", features=X[i % 200] * (
        1 + (i % 50 == 0) * 6)) for i in range(160)]
    store = ck.CheckpointStore(str(workdir), keep_last=3)
    log = online.anomaly_feedback_log(capacity=10_000)
    loop = online.StreamingAnomalyLoop(log, scorer, store=store,
                                       batch_size=16, window=64,
                                       min_window=16, contamination=0.1,
                                       snapshot_every=2)
    for ev in feed:
        log.offer(ev)
    with pytest.raises(ck.PreemptionError):
        with testing.ChaosPreemption(at={"online.anomaly": [6]}):
            loop.run_until_drained()
    resumed = online.StreamingAnomalyLoop(
        online.anomaly_feedback_log(capacity=10_000), scorer, store=store,
        batch_size=16, window=64, min_window=16, contamination=0.1,
        snapshot_every=2)
    assert resumed.restore_latest()
    for ev in feed[resumed.events_seen:]:
        resumed.log.offer(ev)
    resumed.run_until_drained()
    return (resumed.threshold, resumed.flagged, resumed.scored,
            list(resumed._scores), resumed.snapshot_stats())


def test_streaming_anomaly_matches_the_reference(tmp_path):
    got = {name: _anomaly_run(o, t, c, tmp_path / name)
           for name, (o, t, c, _s, _lr, _kw) in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][1] > 0
