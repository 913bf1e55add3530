"""The port's AutoML (``synapseml_tpu_torch/automl``), its perfmodel journal
and ``testing.chaos_candidate``, on the CPU:

* every scenario of ``tests/test_automl_elastic.py`` on the port (its gang
  class keeps its ``slow`` mark), the AutoML scenarios of
  ``tests/test_featurize_train_automl.py`` and the four ``TuneHyperparameters``
  cases of ``tests/test_checkpoint_recovery.py``;
* the same inputs through both packages: ``plan_rungs``, the spaces' draws,
  the candidate keys and search fingerprints, a halving search over the
  same estimator (the same per-candidate metrics), and ``perfmodel.predict``
  (the same decisions on the same journal rows);
* the gang spawns the port's worker module, and a search resumed from a
  checkpoint reads its completed scores back bitwise.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from synapseml_tpu_torch.automl.scheduler import (ElasticHalvingScheduler,
                                                  GangCandidatePool,
                                                  plan_rungs)
from synapseml_tpu_torch.core import perfmodel
from synapseml_tpu_torch.core.checkpoint import CheckpointStore, PreemptionError
from synapseml_tpu_torch.core.logging import (failure_counts,
                                              reset_failure_counts)
from synapseml_tpu_torch.testing import ChaosPreemption, chaos_candidate
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)
from torch_waits import join_thread

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_counters_and_journal(tmp_path, monkeypatch):
    # every test journals into its own file, never the checkout's
    monkeypatch.setattr(perfmodel, "JOURNAL_PATH",
                        str(tmp_path / "perf_rows.jsonl"))
    reset_failure_counts()
    yield
    reset_failure_counts()


def _tune_fixtures():
    from synapseml_tpu_torch.core.params import Param
    from synapseml_tpu_torch.core.pipeline import Estimator, Model

    fits = []

    class ConstModel(Model):
        const = Param("const", "constant prediction", float, 0.0)

        def _transform(self, df):
            return df.with_column(
                "prediction", np.full(df.num_rows, float(self.const)))

    class ConstEstimator(Estimator):
        const = Param("const", "constant", float, 0.0)
        crash = Param("crash", "raise on fit", bool, False)
        hang = Param("hang", "sleep through the budget on fit", bool, False)

        def _fit(self, df):
            fits.append(float(self.const))
            if self.crash:
                raise RuntimeError("deliberate candidate crash")
            if self.hang:
                time.sleep(5.0)
            return ConstModel(const=self.const)

    return ConstEstimator, fits


def _tune_df(seed: int = 0):
    from synapseml_tpu_torch.core.table import Table

    rng = np.random.default_rng(seed)
    return Table({"feature": np.arange(24, dtype=np.float64),
                  "label": rng.normal(size=24)})


def _tuner(Est, consts, *, halving=3, folds=3, ckpt="", **kw):
    from synapseml_tpu_torch.automl import TuneHyperparameters
    from synapseml_tpu_torch.automl.hyperparams import (DiscreteHyperParam,
                                                        HyperparamBuilder)

    space = (HyperparamBuilder()
             .addHyperparam("const", DiscreteHyperParam(consts))
             .build())
    return TuneHyperparameters(
        model=Est(), paramSpace=space, searchMode="grid", numFolds=folds,
        evaluationMetric="rmse", labelCol="label", halvingEta=halving,
        checkpointDir=ckpt, **kw)


# ---------------------------------------------------------------------------
# rung ladder math
# ---------------------------------------------------------------------------

class TestPlanRungs:
    def test_geometric_ladder(self):
        rungs = plan_rungs(12, 6, eta=3, min_resource=1)
        assert [(r.resource, r.survivors) for r in rungs] == \
            [(1, 12), (3, 4), (6, 2)]

    def test_final_rung_always_full_resource(self):
        for n, total, eta, lo in [(9, 4, 3, 1), (20, 5, 2, 1), (7, 6, 3, 2)]:
            rungs = plan_rungs(n, total, eta=eta, min_resource=lo)
            assert rungs[-1].resource == total
            assert rungs[0].survivors == n
            res = [r.resource for r in rungs]
            assert res == sorted(res)

    def test_eta_disabled_degenerates_to_exhaustive(self):
        assert [(r.resource, r.survivors) for r in plan_rungs(4, 2, eta=0)] \
            == [(2, 4)]
        assert [(r.resource, r.survivors) for r in plan_rungs(4, 2, eta=1)] \
            == [(2, 4)]

    def test_single_candidate_or_no_headroom(self):
        assert plan_rungs(1, 5, eta=3)[0].resource == 5
        assert len(plan_rungs(8, 2, eta=3, min_resource=2)) == 1

    def test_halving_budget_is_under_forty_percent_of_exhaustive(self):
        # the bench guard's math: 12 candidates × 6 folds
        rungs = plan_rungs(12, 6, eta=3, min_resource=1)
        spent, prev = 0, 0
        for r in rungs:
            spent += r.survivors * (r.resource - prev)
            prev = r.resource
        assert spent / (12 * 6) <= 0.40

    def test_exhaustive_and_halving_agree_on_winner(self):
        Est, _ = _tune_fixtures()
        df = _tune_df()
        exhaustive = _tuner(Est, [0.0, 0.5, 1.0, 2.0], halving=0).fit(df)
        halved = _tuner(Est, [0.0, 0.5, 1.0, 2.0], halving=2,
                        minResourceFolds=1).fit(df)
        assert halved.bestParams == exhaustive.bestParams
        assert halved.bestMetric == pytest.approx(exhaustive.bestMetric)

    def test_ladders_are_the_jax_packages(self):
        from synapseml_tpu.automl.scheduler import plan_rungs as jplan

        for n in range(1, 30, 3):
            for total in (1, 2, 3, 5, 8):
                for eta in (0, 2, 3, 4):
                    for lo in (1, 2):
                        assert plan_rungs(n, total, eta, lo) == [
                            type(plan_rungs(1, 1)[0])(*vars(r).values())
                            for r in jplan(n, total, eta, lo)]


# ---------------------------------------------------------------------------
# chaos: the kill→resume invariant
# ---------------------------------------------------------------------------

class TestChaosInvariant:
    CONSTS = [0.0, 0.5, 1.0, 1.5, 2.0, 3.0]
    CHAOS = dict(seed=11, p_crash=0.2, p_nan=0.1, p_slow=0.3, slow_s=0.01)

    def _run(self, Est, ckpt):
        return _tuner(Est, self.CONSTS, halving=3, folds=3, ckpt=ckpt,
                      parallelism=2, maxAttempts=2).fit(_tune_df())

    def test_interrupted_chaotic_search_resumes_to_identical_best(
            self, tmp_path):
        Est, fits = _tune_fixtures()
        with chaos_candidate(**self.CHAOS):
            baseline = self._run(Est, "")

        d = str(tmp_path / "bracket")
        Est2, fits2 = _tune_fixtures()
        interrupted = False
        try:
            # candidate 4 is the one whose rung-0 attempt the chaos seed
            # leaves clean, so its preemption boundary is really reached
            with chaos_candidate(**self.CHAOS), \
                    ChaosPreemption(at={"automl.candidate": [4]}):
                self._run(Est2, d)
        except PreemptionError:
            interrupted = True
        assert interrupted, "the mid-bracket kill must really fire"
        mid_run_fits = len(fits2)

        with chaos_candidate(**self.CHAOS):
            resumed = self._run(Est2, d)

        assert resumed.bestParams == baseline.bestParams
        assert resumed.bestMetric == pytest.approx(baseline.bestMetric)
        got = [r["metric"] for r in resumed.allResults]
        want = [r["metric"] for r in baseline.allResults]
        np.testing.assert_allclose(got, want, equal_nan=True)
        assert mid_run_fits < len(fits)
        assert len(fits2) <= 2 * len(fits)

    def test_chaos_is_pure_per_coordinates(self):
        c = chaos_candidate(seed=3, p_crash=0.3, p_hang=0.2, p_nan=0.2)
        assert c.action("k1", 0, 0) == c.action("k1", 0, 0)
        draws = {c.action(f"k{i}", r, a)
                 for i in range(30) for r in range(2) for a in range(2)}
        assert None in draws and len(draws) > 2   # faults AND clean runs

    def test_chaos_draws_are_the_jax_packages(self):
        from synapseml_tpu.testing import chaos_candidate as jchaos

        kw = dict(seed=5, p_crash=0.2, p_hang=0.1, p_nan=0.3, p_slow=0.1)
        t, j = chaos_candidate(**kw), jchaos(**kw)
        assert [t.action(f"k{i}", r, a) for i in range(40) for r in range(3)
                for a in range(2)] == \
            [j.action(f"k{i}", r, a) for i in range(40) for r in range(3)
             for a in range(2)]

    def test_chaos_hook_does_not_nest(self):
        with chaos_candidate(seed=1):
            with pytest.raises(RuntimeError, match="nest"):
                with chaos_candidate(seed=2):
                    pass

    def test_chaos_hook_is_the_ports_scheduler_slot(self):
        from synapseml_tpu.automl import scheduler as jsch
        from synapseml_tpu_torch.automl import scheduler as tsch

        with chaos_candidate(seed=1) as c:
            assert tsch._CHAOS_HOOK == c._hook
            assert jsch._CHAOS_HOOK is None
        assert tsch._CHAOS_HOOK is None


# ---------------------------------------------------------------------------
# hang reaping: no candidate stalls the pool past its budget
# ---------------------------------------------------------------------------

class TestHangReaping:
    def test_hung_candidate_is_reaped_within_budget(self):
        from synapseml_tpu_torch.automl import TuneHyperparameters
        from synapseml_tpu_torch.automl.hyperparams import (
            DiscreteHyperParam, HyperparamBuilder)

        Est, _ = _tune_fixtures()
        space = (HyperparamBuilder()
                 .addHyperparam("const", DiscreteHyperParam([0.0, 1.0]))
                 .addHyperparam("hang", DiscreteHyperParam([False, True]))
                 .build())
        t0 = time.monotonic()
        m = TuneHyperparameters(
            model=Est(), paramSpace=space, searchMode="grid", numFolds=2,
            evaluationMetric="rmse", labelCol="label", parallelism=2,
            candidateBudgetSeconds=1.0,
        ).fit(_tune_df())
        elapsed = time.monotonic() - t0
        assert elapsed < 8.0, f"hung candidates stalled the search {elapsed}s"
        assert m.bestParams["hang"] is False
        assert failure_counts().get("automl.candidate_hang", 0) == 2
        nan_results = [r for r in m.allResults if np.isnan(r["metric"])]
        assert len(nan_results) == 2

    def test_chaos_hang_is_reaped_not_retried(self):
        Est, fits = _tune_fixtures()
        chaos = chaos_candidate(seed=0, p_hang=1.0, hang_s=30.0)
        try:
            with chaos:
                with pytest.raises(ValueError,
                                   match="every candidate scored NaN"):
                    _tuner(Est, [1.0], halving=0, folds=2,
                           candidateBudgetSeconds=0.5).fit(_tune_df())
        finally:
            chaos.release()
        assert failure_counts().get("automl.candidate_hang", 0) == 1
        assert failure_counts().get("automl.candidate_retry", 0) == 0
        assert fits == []   # the hook hangs before the fold fit


# ---------------------------------------------------------------------------
# dedup, all-NaN, fingerprints, stale records
# ---------------------------------------------------------------------------

class TestSchedulerContracts:
    def test_duplicate_candidates_compute_once_and_share_score(self):
        from synapseml_tpu_torch.automl import TuneHyperparameters
        from synapseml_tpu_torch.automl.hyperparams import (
            DiscreteHyperParam, HyperparamBuilder)

        Est, fits = _tune_fixtures()
        space = (HyperparamBuilder()
                 .addHyperparam("const", DiscreteHyperParam([0.5]))
                 .build())
        m = TuneHyperparameters(
            model=Est(), paramSpace=space, searchMode="random", numRuns=4,
            numFolds=2, evaluationMetric="rmse", labelCol="label",
        ).fit(_tune_df())
        assert len(m.allResults) == 4              # every draw reported
        metrics = [r["metric"] for r in m.allResults]
        assert len(set(metrics)) == 1              # ...sharing ONE score
        assert np.isfinite(metrics[0])
        assert len(fits) == 2 + 1                  # k folds once + best refit

    def test_duplicate_keys_collapse_in_scheduler(self):
        calls = []

        def run_folds(i, params, lo, hi):
            calls.append((i, lo, hi))
            return [float(params["x"])] * (hi - lo)

        sch = ElasticHalvingScheduler(
            run_folds, [{"x": 1.0}, {"x": 2.0}, {"x": 1.0}],
            ["ka", "kb", "ka"], maximize=False, total_folds=2, eta=0)
        res = sch.run()
        assert sch.duplicates == 1
        assert sorted(k for k, _, _ in calls) == [0, 1]   # ka once, kb once
        assert res["ka"]["metric"] == 1.0

    def test_all_nan_raises_under_halving(self):
        from synapseml_tpu_torch.automl import TuneHyperparameters
        from synapseml_tpu_torch.automl.hyperparams import (
            DiscreteHyperParam, HyperparamBuilder)

        Est, _ = _tune_fixtures()
        space = (HyperparamBuilder()
                 .addHyperparam("const", DiscreteHyperParam([0.0, 1.0, 2.0]))
                 .addHyperparam("crash", DiscreteHyperParam([True]))
                 .build())
        with pytest.raises(ValueError, match="every candidate scored NaN"):
            TuneHyperparameters(
                model=Est(), paramSpace=space, searchMode="grid", numFolds=3,
                evaluationMetric="rmse", labelCol="label", halvingEta=3,
            ).fit(_tune_df())
        assert failure_counts().get("automl.candidate_failure", 0) == 3

    def test_resume_against_changed_data_refuses_loudly(self, tmp_path):
        Est, _ = _tune_fixtures()
        d = str(tmp_path / "bracket")
        _tuner(Est, [0.0, 1.0], halving=0, folds=2, ckpt=d).fit(_tune_df(0))
        with pytest.raises(ValueError, match="resume refused"):
            _tuner(Est, [0.0, 1.0], halving=0, folds=2,
                   ckpt=d).fit(_tune_df(1))
        assert failure_counts().get("automl.candidate_record_stale", 0) == 2
        assert failure_counts().get("automl.candidate_record_corrupt", 0) == 0

    def test_stale_candidate_record_is_ignored_with_counter(self, tmp_path):
        Est, fits = _tune_fixtures()
        d = str(tmp_path / "bracket")
        _tuner(Est, [0.0, 1.0], halving=0, folds=2, ckpt=d).fit(_tune_df())
        rec = sorted(f for f in os.listdir(d) if f.startswith("cand_"))[0]
        path = os.path.join(d, rec)
        with open(path) as f:
            record = json.load(f)
        record["fingerprint"] = "deadbeef" * 3
        with open(path, "w") as f:
            json.dump(record, f)
        n_before = len(fits)
        m = _tuner(Est, [0.0, 1.0], halving=0, folds=2, ckpt=d).fit(_tune_df())
        assert failure_counts().get("automl.candidate_record_stale", 0) == 1
        assert len(fits) > n_before            # the stale one recomputed
        assert all(np.isfinite(r["metric"]) for r in m.allResults)

    def test_explicit_budget_wins_over_perfmodel_price(self):
        sch = ElasticHalvingScheduler(
            lambda i, p, lo, hi: [0.0] * (hi - lo), [{"x": 1}], ["k"],
            total_folds=2, eta=0, budget_s=7.5)
        assert sch._task_budget(2) == 7.5
        sch2 = ElasticHalvingScheduler(
            lambda i, p, lo, hi: [0.0] * (hi - lo), [{"x": 1}], ["k"],
            total_folds=2, eta=0)
        # no explicit budget + no confident model ⇒ no reaper at all
        assert sch2._task_budget(2) is None

    def test_perf_journal_writes_automl_rung_rows(self):
        rows_before = len(perfmodel.training_rows("automl_rung"))
        Est, _ = _tune_fixtures()
        _tuner(Est, [0.0, 1.0], halving=0, folds=2,
               perfJournal=True).fit(_tune_df())
        rows = perfmodel.training_rows("automl_rung")
        assert len(rows) > rows_before
        assert all(r["arm"] == "cv_fold" for r in rows)
        # keyed by the port's platform, in the port's own journal
        assert {r["platform"] for r in rows} == {perfmodel.current_platform()}
        assert os.path.exists(perfmodel.JOURNAL_PATH)

    def test_journaled_rows_price_the_next_search(self):
        """Matched rows of this platform make the budget confident: the
        reaper is then armed at 4x the predicted seconds."""
        feats = {"rows": 24.0, "cols": 1.0, "folds": 2.0}
        for s in (0.5, 0.52, 0.48):
            perfmodel.append_training_row("automl_rung", "cv_fold", feats, s)
        sch = ElasticHalvingScheduler(
            lambda i, p, lo, hi: [0.0] * (hi - lo), [{"x": 1}], ["k"],
            total_folds=2, eta=0, perf_features={"rows": 24.0, "cols": 1.0})
        assert sch._task_budget(2) == pytest.approx(4.0 * 0.5, rel=0.05)
        other = "cpu" if perfmodel.current_platform() == "gpu" else "gpu"
        assert perfmodel.predict(perfmodel.Candidate(
            "automl_rung", "cv_fold", feats), platform=other).source == "none"


# ---------------------------------------------------------------------------
# perfmodel.predict against the JAX package's on the same rows
# ---------------------------------------------------------------------------

def _journal_rows(seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for arm in ("cv_fold", "other"):
        for _ in range(12):
            f = {"rows": float(rng.integers(100, 100000)),
                 "cols": float(rng.integers(1, 200)),
                 "folds": float(rng.integers(1, 4))}
            sec = 1e-5 * f["rows"] * f["folds"] * (1 + 0.05 * rng.random())
            rows.append({"perf_row": 1, "kind": "automl_rung", "arm": arm,
                         "features": f, "observed_s": sec,
                         "platform": "gpu"})
    return rows


@pytest.mark.parametrize("case", ["matched", "fitted", "analytic", "none",
                                  "extrapolated", "missing_key"])
def test_predict_is_the_jax_packages(case):
    from synapseml_tpu.core import perfmodel as jperf

    rows = _journal_rows()
    f = dict(rows[3]["features"])
    analytic = None
    if case == "fitted":
        f["rows"] *= 1.7
    elif case == "analytic":
        f = {"other": 1.0}
        analytic = 0.25
    elif case == "none":
        f = {"other": 1.0}
    elif case == "extrapolated":
        f["rows"] = 1e12
    elif case == "missing_key":
        f.pop("cols")
    t = perfmodel.predict(perfmodel.Candidate("automl_rung", "cv_fold", f,
                                              analytic_s=analytic),
                          rows=rows, platform="gpu")
    j = jperf.predict(jperf.Candidate("automl_rung", "cv_fold", f,
                                      analytic_s=analytic),
                      rows=rows, platform="gpu")
    assert (t.seconds, t.confidence, t.source, t.detail) \
        == (j.seconds, j.confidence, j.source, j.detail)
    assert perfmodel.predict_runtime(
        perfmodel.Candidate("automl_rung", "cv_fold", f,
                            analytic_s=analytic), rows=rows) \
        == jperf.predict_runtime(jperf.Candidate(
            "automl_rung", "cv_fold", f, analytic_s=analytic), rows=rows)


def test_journal_round_trip_is_the_jax_packages(tmp_path):
    from synapseml_tpu.core import perfmodel as jperf

    tp, jp = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    for row in _journal_rows(1)[:10]:
        kw = dict(platform=row["platform"], captured_at="2026-01-01T00:00:00")
        perfmodel.append_training_row(row["kind"], row["arm"],
                                      row["features"], row["observed_s"],
                                      path=tp, rung=2, **kw)
        jperf.append_training_row(row["kind"], row["arm"], row["features"],
                                  row["observed_s"], path=jp, rung=2, **kw)
    with open(tp) as a, open(jp) as b:
        assert a.read() == b.read()
    with open(tp, "a") as f:
        f.write("not json\n{\"perf_row\": 1}\n")
    assert perfmodel.training_rows(path=tp, kind="automl_rung") \
        == jperf.training_rows(path=tp, kind="automl_rung")
    assert len(perfmodel.training_rows(path=tp, platform="gpu")) == 10
    assert perfmodel.training_rows(path=str(tmp_path / "absent")) == []


# ---------------------------------------------------------------------------
# the AutoML scenarios of test_featurize_train_automl.py, on the port
# ---------------------------------------------------------------------------

def test_hyperparam_spaces():
    from synapseml_tpu_torch.automl import (DiscreteHyperParam, GridSpace,
                                            HyperparamBuilder, RandomSpace,
                                            RangeHyperParam)

    space = (HyperparamBuilder()
             .addHyperparam("numLeaves", DiscreteHyperParam([7, 15]))
             .addHyperparam("learningRate", RangeHyperParam(0.01, 0.3,
                                                            log=True))
             .build())
    grid = list(GridSpace(space, grid_points=3))
    assert len(grid) == 2 * 3
    rand = list(RandomSpace(space, 5, seed=1))
    assert len(rand) == 5
    assert all(0.01 <= c["learningRate"] <= 0.3 for c in rand)
    assert all(c["numLeaves"] in (7, 15) for c in rand)


def test_spaces_keys_and_fingerprints_are_the_jax_packages():
    from synapseml_tpu import automl as jautoml
    from synapseml_tpu.automl import tune as jtune
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu_torch import automl as tautoml
    from synapseml_tpu_torch.automl import tune as ttune
    from synapseml_tpu_torch.core.table import Table

    def space(m):
        return (m.HyperparamBuilder()
                .addHyperparam("numLeaves", m.DiscreteHyperParam([15, 31, 63]))
                .addHyperparam("learningRate",
                               m.RangeHyperParam(0.05, 0.3, log=True))
                .addHyperparam("minDataInLeaf", m.RangeHyperParam(5, 50))
                .build())

    ts, js = space(tautoml), space(jautoml)
    assert list(tautoml.RandomSpace(ts, 8, seed=3)) \
        == list(jautoml.RandomSpace(js, 8, seed=3))
    assert list(tautoml.GridSpace(ts, 4)) == list(jautoml.GridSpace(js, 4))
    for p in tautoml.RandomSpace(ts, 8, seed=3):
        assert ttune.TuneHyperparameters._candidate_key(p) \
            == jtune.TuneHyperparameters._candidate_key(p)
    rng = np.random.default_rng(0)
    cols = {"features": rng.normal(size=(30, 3)).astype(np.float32),
            "s": np.array([f"v{i % 4}" for i in range(30)]),
            "label": (rng.random(30) > 0.5).astype(np.float32)}
    kw = dict(searchMode="random", numRuns=8, numFolds=3, seed=3)
    t = ttune.TuneHyperparameters(paramSpace=ts, **kw)._fingerprint(
        Table(cols), 3, "AUC")
    j = jtune.TuneHyperparameters(paramSpace=js, **kw)._fingerprint(
        JTable(cols), 3, "AUC")
    assert t == j
    assert ttune._data_digest(Table(cols)) == jtune._data_digest(JTable(cols))


@pytest.fixture(scope="module")
def binary_table(binary_data):
    from synapseml_tpu_torch.core.table import Table

    Xtr, Xte, ytr, yte = binary_data
    return (Table({"features": Xtr[:150], "label": ytr[:150]}),
            Table({"features": Xte, "label": yte}), Xtr, ytr)


def test_tune_hyperparameters_cv(binary_table):
    from synapseml_tpu_torch.automl import (DiscreteHyperParam,
                                            HyperparamBuilder,
                                            TuneHyperparameters)
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.models import LightGBMClassifier

    df, te, _, _ = binary_table
    space = (HyperparamBuilder()
             .addHyperparam("numLeaves", DiscreteHyperParam([3, 15]))
             .build())
    tuned = TuneHyperparameters(
        model=LightGBMClassifier(numIterations=10, device=CPU),
        paramSpace=space, searchMode="grid", numFolds=2,
        evaluationMetric="AUC", parallelism=2).fit(df)
    info = tuned.getBestModelInfo()
    assert info["params"]["numLeaves"] in (3, 15)
    assert 0.5 < info["metric"] <= 1.0
    out = tuned.transform(Table({"features": te["features"]}))
    assert "prediction" in out
    assert len(tuned.allResults) == 2


def test_find_best_model(binary_table):
    from synapseml_tpu_torch.automl import FindBestModel
    from synapseml_tpu_torch.core.table import Table
    from synapseml_tpu_torch.models import LightGBMClassifier

    _, te, Xtr, ytr = binary_table
    tr = Table({"features": Xtr, "label": ytr})
    weak = LightGBMClassifier(numIterations=1, numLeaves=2,
                              device=CPU).fit(tr)
    strong = LightGBMClassifier(numIterations=30, device=CPU).fit(tr)
    best = FindBestModel(models=[weak, strong], evaluationMetric="AUC").fit(te)
    assert best.bestModel is strong
    assert len(best.allModelMetrics) == 2


def test_halving_search_scores_are_the_jax_packages(binary_table, tmp_path):
    """A 2-candidate, 3-fold halving search over LightGBM by both packages
    (the port on the CPU): the same trees, so the same fold AUCs (the JAX
    package's within 1e-6) and the same winner; and the port's search,
    killed after its first candidate and resumed from its checkpoint, reads
    every completed fold score back bitwise and names the same winner."""
    from synapseml_tpu import automl as jautoml
    from synapseml_tpu.core.table import Table as JTable
    from synapseml_tpu.models import LightGBMClassifier as JLGBM
    from synapseml_tpu_torch import automl as tautoml
    from synapseml_tpu_torch.models import LightGBMClassifier

    df = binary_table[0]
    cols = {c: df[c] for c in df.columns}

    def tuner(m, est, ckpt=""):
        space = (m.HyperparamBuilder()
                 .addHyperparam("numLeaves", m.DiscreteHyperParam([3, 7]))
                 .build())
        return m.TuneHyperparameters(
            model=est, paramSpace=space, searchMode="grid", numFolds=3,
            halvingEta=2, parallelism=1, evaluationMetric="AUC",
            checkpointDir=ckpt)

    est = LightGBMClassifier(numIterations=3, device=CPU)
    t = tuner(tautoml, est).fit(df)
    j = tuner(jautoml, JLGBM(numIterations=3)).fit(JTable(cols))
    assert t.bestParams == j.bestParams
    np.testing.assert_allclose([r["metric"] for r in t.allResults],
                               [r["metric"] for r in j.allResults],
                               rtol=0, atol=1e-6)

    d = str(tmp_path / "ckpt")
    with pytest.raises(PreemptionError):
        with ChaosPreemption(at={"automl.candidate": [1]}):
            tuner(tautoml, est, d).fit(df)
    before = json.loads(CheckpointStore(os.path.join(d, "bracket"))
                        .load_latest().artifacts["bracket.json"])
    assert before["fold_scores"]
    resumed = tuner(tautoml, est, d).fit(df)
    after = json.loads(CheckpointStore(os.path.join(d, "bracket"))
                       .load_latest().artifacts["bracket.json"])
    for k, scores in before["fold_scores"].items():
        assert after["fold_scores"][k][:len(scores)] == scores
    assert resumed.bestParams == t.bestParams
    assert [r["metric"] for r in resumed.allResults] \
        == [r["metric"] for r in t.allResults]


# ---------------------------------------------------------------------------
# the TuneHyperparameters cases of test_checkpoint_recovery.py, on the port
# ---------------------------------------------------------------------------

def _recovery_df():
    from synapseml_tpu_torch.core.table import Table

    return Table({"feature": np.arange(20, dtype=np.float64),
                  "label": np.asarray([0.0, 1.0] * 10)})


class TestTuneRecovery:
    def test_crashing_candidate_does_not_abort_search(self):
        from synapseml_tpu_torch.automl import TuneHyperparameters
        from synapseml_tpu_torch.automl.hyperparams import (
            DiscreteHyperParam, HyperparamBuilder)

        Est, _ = _tune_fixtures()
        space = (HyperparamBuilder()
                 .addHyperparam("const", DiscreteHyperParam([0.0, 1.0]))
                 .addHyperparam("crash", DiscreteHyperParam([False, True]))
                 .build())
        m = TuneHyperparameters(
            model=Est(), paramSpace=space, searchMode="grid", numFolds=2,
            evaluationMetric="rmse", parallelism=2, labelCol="label",
        ).fit(_recovery_df())
        assert m.bestParams["crash"] is False
        nan_results = [r for r in m.allResults if np.isnan(r["metric"])]
        assert len(nan_results) == 2
        assert failure_counts().get("automl.candidate_failure", 0) == 2

    def test_all_candidates_crashing_raises_clear_error(self):
        from synapseml_tpu_torch.automl import TuneHyperparameters
        from synapseml_tpu_torch.automl.hyperparams import (
            DiscreteHyperParam, HyperparamBuilder)

        Est, _ = _tune_fixtures()
        space = (HyperparamBuilder()
                 .addHyperparam("crash", DiscreteHyperParam([True]))
                 .build())
        with pytest.raises(ValueError, match="every candidate scored NaN"):
            TuneHyperparameters(
                model=Est(), paramSpace=space, searchMode="grid", numFolds=2,
                evaluationMetric="rmse", parallelism=1, labelCol="label",
            ).fit(_recovery_df())

    def test_interrupted_search_skips_completed_candidates(self, tmp_path):
        from synapseml_tpu_torch.automl import TuneHyperparameters
        from synapseml_tpu_torch.automl.hyperparams import (
            DiscreteHyperParam, HyperparamBuilder)

        Est, fits = _tune_fixtures()
        d = str(tmp_path / "tune")
        consts = [0.0, 1.0, 2.0, 3.0]

        def tuner():
            space = (HyperparamBuilder()
                     .addHyperparam("const", DiscreteHyperParam(consts))
                     .build())
            return TuneHyperparameters(
                model=Est(), paramSpace=space, searchMode="grid", numFolds=2,
                evaluationMetric="rmse", parallelism=1, labelCol="label",
                checkpointDir=d)

        with pytest.raises(PreemptionError):
            with ChaosPreemption(at={"automl.candidate": [2]}):
                tuner().fit(_recovery_df())
        first_run_fits = len(fits)
        assert first_run_fits < len(consts) * 2   # the search really died
        m = tuner().fit(_recovery_df())
        assert len(fits) - first_run_fits == 2 + 1
        assert len(m.allResults) == len(consts)
        assert all(np.isfinite(r["metric"]) for r in m.allResults)

    def test_corrupt_candidate_record_is_recomputed(self, tmp_path):
        from synapseml_tpu_torch.automl import TuneHyperparameters
        from synapseml_tpu_torch.automl.hyperparams import (
            DiscreteHyperParam, HyperparamBuilder)

        Est, fits = _tune_fixtures()
        d = str(tmp_path / "tune")

        def tuner():
            space = (HyperparamBuilder()
                     .addHyperparam("const", DiscreteHyperParam([0.0, 1.0]))
                     .build())
            return TuneHyperparameters(
                model=Est(), paramSpace=space, searchMode="grid", numFolds=2,
                evaluationMetric="rmse", parallelism=1, labelCol="label",
                checkpointDir=d)

        tuner().fit(_recovery_df())
        rec = sorted(f for f in os.listdir(d) if f.startswith("cand_"))[0]
        with open(os.path.join(d, rec), "w") as f:
            f.write("{ torn json")
        n = len(fits)
        m = tuner().fit(_recovery_df())
        assert failure_counts().get("automl.candidate_record_corrupt", 0) == 1
        assert len(fits) - n == 2 + 1      # the torn one refit + best refit
        assert all(np.isfinite(r["metric"]) for r in m.allResults)


# ---------------------------------------------------------------------------
# the gang: spool workers under a TrainingSupervisor
# ---------------------------------------------------------------------------

ECHO = "synapseml_tpu_torch.automl.worker:_echo"


def test_the_gang_runs_the_ports_worker_module(tmp_path):
    """One worker spawned by the pool is the port's module (its command
    line), and a task round-trips through it."""
    with GangCandidatePool(world_size=1,
                           spool_dir=str(tmp_path / "sp")) as pool:
        proc = pool.supervisor.procs[0]
        assert "synapseml_tpu_torch.automl.worker" in proc.args
        assert pool.run_task({"entry": ECHO, "payload": {"value": [3]}},
                             budget_s=120.0) == [3]


@pytest.mark.slow
class TestGangCandidatePool:
    def test_task_roundtrip_and_failed_task_is_a_result(self, tmp_path):
        with GangCandidatePool(world_size=1,
                               spool_dir=str(tmp_path / "sp")) as pool:
            out = pool.run_task({"entry": ECHO, "payload": {"value": [1, 2]}},
                                budget_s=120.0)
            assert out == [1, 2]
            with pytest.raises(RuntimeError, match="failed in worker"):
                pool.run_task({"entry": ECHO, "payload": {"crash": True}},
                              budget_s=120.0)

    def test_kill_rank_mid_task_respawns_and_respools(self, tmp_path):
        from synapseml_tpu_torch.testing import kill_rank

        spool = str(tmp_path / "sp")
        with GangCandidatePool(world_size=1, spool_dir=spool) as pool:
            assert pool.run_task({"entry": ECHO, "payload": {"value": 1}},
                                 budget_s=120.0) == 1
            box = {}

            def _submit():
                box["out"] = pool.run_task(
                    {"entry": ECHO,
                     "payload": {"value": "ok", "sleep_s": 3.0}},
                    budget_s=180.0)

            t = threading.Thread(target=_submit, daemon=True)
            t.start()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                claims = [f for f in os.listdir(spool) if ".claimed.r" in f]
                if claims:
                    break
                time.sleep(0.05)
            assert claims, "worker never claimed the slow task"
            kill_rank(pool.supervisor, 0)          # kill_rank mid-task
            join_thread(t, what="the re-spooled task")
            assert box.get("out") == "ok"

    def test_missing_result_past_budget_raises_peer_lost(self, tmp_path):
        from synapseml_tpu_torch.parallel.elastic import PeerLostError

        with GangCandidatePool(world_size=1,
                               spool_dir=str(tmp_path / "sp")) as pool:
            assert pool.run_task({"entry": ECHO, "payload": {"value": 1}},
                                 budget_s=120.0) == 1
            with pytest.raises(PeerLostError):
                pool.run_task({"entry": ECHO,
                               "payload": {"value": 0, "sleep_s": 30.0}},
                              budget_s=1.0)


class TestWorkerModule:
    def test_run_worker_claims_runs_and_reports(self, tmp_path):
        from synapseml_tpu_torch.automl.worker import run_worker
        from synapseml_tpu_torch.core.checkpoint import atomic_write_text

        spool = str(tmp_path)
        atomic_write_text(
            os.path.join(spool, "task_000001.json"),
            json.dumps({"id": "000001", "entry": "json:dumps",
                        "payload": {"obj": [1, 2]}}))
        assert run_worker(spool, rank=0, max_tasks=1) == 1
        with open(os.path.join(spool, "result_000001.json")) as f:
            rec = json.load(f)
        assert rec["ok"] and json.loads(rec["value"]) == [1, 2]
        assert not any(f.startswith("task_") for f in os.listdir(spool))
        assert any(f.startswith("hb_p0") for f in os.listdir(spool))

    def test_worker_failed_task_writes_error_result(self, tmp_path):
        from synapseml_tpu_torch.automl.worker import run_worker
        from synapseml_tpu_torch.core.checkpoint import atomic_write_text

        spool = str(tmp_path)
        atomic_write_text(
            os.path.join(spool, "task_000001.json"),
            json.dumps({"id": "000001", "entry": ECHO,
                        "payload": {"crash": True}}))
        run_worker(spool, rank=0, max_tasks=1)
        with open(os.path.join(spool, "result_000001.json")) as f:
            rec = json.load(f)
        assert rec["ok"] is False
        assert "deliberate _echo crash" in rec["error"]

    def test_worker_stops_on_stop_file(self, tmp_path):
        from synapseml_tpu_torch.automl.worker import run_worker
        from synapseml_tpu_torch.core.checkpoint import atomic_write_text

        atomic_write_text(os.path.join(str(tmp_path), "stop"), "stop")
        assert run_worker(str(tmp_path), rank=0) == 0
