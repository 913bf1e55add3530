"""TuneHyperparameters + FindBestModel on the elastic halving scheduler.

Reference: core/.../automl/TuneHyperparameters.scala:38-228 (random/grid search
with parallel cross-validation over a thread pool; metric selects best) and
FindBestModel.scala (evaluate fitted models on a dataset, pick the winner).

The search substrate is :mod:`automl.scheduler`: every candidate is a
preemptible elastic job — budget-reaped when hung, respawned on crash,
early-stopped by successive-halving rungs (``halvingEta``), and checkpointed
(bracket state + fingerprinted per-candidate ``cand_<sha>.json`` records) so
kill→resume converges to the identical best model. With the default
``halvingEta=0`` the bracket degenerates to one full-CV rung: the classic
exhaustive search, minus none of the fault isolation. See docs/automl.md.

Parallelism note: candidate fits run on a host thread pool like the reference;
each fit's device work is serialized on the card's stream, so threads mainly overlap
host-side featurization + dispatch. On multi-chip meshes candidates can be
placed on disjoint cards by the caller.

The port's copy of the JAX package's ``automl/tune.py`` (host code; the port
imports nothing of that package).
"""

from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Tuple

import numpy as np

from ..core.checkpoint import CheckpointStore, atomic_write_text, \
    preemption_point
from ..core.logging import record_failure
from ..core.params import Param, HasLabelCol
from ..core.pipeline import Estimator, Model, Transformer
from ..core.table import Table
from ..train.metrics import auc_score, regression_metrics
from .scheduler import ElasticHalvingScheduler, fingerprint_digest
from .hyperparams import (DiscreteHyperParam, GridSpace, RandomSpace,
                          RangeHyperParam)

_MAXIMIZE = {"AUC", "accuracy", "precision", "recall", "f1", "R^2", "ndcg"}


def _evaluate(model: Transformer, df: Table, metric: str, label_col: str) -> float:
    scored = model.transform(df)
    y = np.asarray(df[label_col], np.float64)
    if metric == "AUC":
        s = scored["probability"][:, -1] if "probability" in scored else \
            np.asarray(scored["prediction"], np.float64)
        return auc_score(y, s)
    if metric in ("accuracy", "precision", "recall", "f1"):
        from ..train.metrics import binary_classification_metrics
        return float(binary_classification_metrics(
            y, np.asarray(scored["prediction"], np.float64))[metric])
    m = regression_metrics(y, scored["prediction"])
    return float(m[metric if metric in m else "rmse"])


def _space_desc(spec: Any) -> Any:
    """Stable (address-free) description of one hyperparam space — the
    default object repr embeds the instance id, which would make every run
    look like a different search."""
    if isinstance(spec, DiscreteHyperParam):
        return ["discrete", [repr(v) for v in spec.values]]
    if isinstance(spec, RangeHyperParam):
        return ["range", repr(spec.low), repr(spec.high),
                bool(spec.log), bool(spec.integer)]
    return ["opaque", type(spec).__name__,
            sorted((k, repr(v)) for k, v in vars(spec).items()
                   if not k.startswith("_"))]


def _data_digest(df: Table) -> str:
    """Content digest of the training table — one pass of sha256 over every
    column's bytes, so a search resumed on different data is detectable."""
    h = hashlib.sha256()
    for name in sorted(df.columns):
        h.update(name.encode("utf-8"))
        h.update(b"\x00")
        h.update(np.ascontiguousarray(np.asarray(df[name])).tobytes())
    return h.hexdigest()[:24]


def _load_candidate_records(ckpt_dir: str, fp_digest: str
                            ) -> Tuple[Dict[str, float], List[str]]:
    """Read ``cand_<key>.json`` resume records: ``(completed, invalid)``.

    Corrupt records count ``automl.candidate_record_corrupt``; records whose
    fingerprint is missing or names a different data/space/metric/folds
    identity count ``automl.candidate_record_stale``. Both land in
    ``invalid`` so their candidates recompute instead of silently reusing a
    wrong score."""
    completed: Dict[str, float] = {}
    invalid: List[str] = []
    for fn in sorted(os.listdir(ckpt_dir)):
        if not (fn.startswith("cand_") and fn.endswith(".json")):
            continue
        key = fn[5:-5]
        try:
            with open(os.path.join(ckpt_dir, fn)) as f:
                rec = json.load(f)
            val = float(rec["metric"])
        except (OSError, ValueError, KeyError, TypeError):
            record_failure("automl.candidate_record_corrupt", file=fn)
            invalid.append(key)
            continue
        if rec.get("fingerprint") != fp_digest:
            record_failure("automl.candidate_record_stale", file=fn,
                           found=rec.get("fingerprint"), expected=fp_digest)
            invalid.append(key)
            continue
        completed[key] = val
    return completed, invalid


class TuneHyperparameters(Estimator, HasLabelCol):
    """Random/grid hyperparameter search with k-fold CV (elastic bracket)."""
    model = Param("model", "Base estimator (its copy is refit per candidate)", object)
    paramSpace = Param("paramSpace", "Dict name→hyperparam space "
                       "(HyperparamBuilder.build())", object)
    searchMode = Param("searchMode", "random | grid", str, "random")
    numRuns = Param("numRuns", "Candidates for random search", int, 10)
    numFolds = Param("numFolds", "Cross-validation folds", int, 3)
    evaluationMetric = Param("evaluationMetric", "AUC | accuracy | f1 | rmse | ...",
                             str, "AUC")
    parallelism = Param("parallelism", "Concurrent candidate fits", int, 4)
    seed = Param("seed", "Search/CV seed", int, 0)
    checkpointDir = Param("checkpointDir", "Directory persisting the bracket "
                          "state and per-candidate results; an interrupted "
                          "search resumes to the identical best model and "
                          "refuses a resume whose data/space/metric/folds "
                          "fingerprint changed", str, "")
    halvingEta = Param("halvingEta", "Successive-halving reduction factor; "
                       "0/1 disables early stopping (single full-CV rung)",
                       int, 0)
    minResourceFolds = Param("minResourceFolds", "CV folds every candidate "
                             "runs at the first rung when halving", int, 1)
    candidateBudgetSeconds = Param("candidateBudgetSeconds", "Wall-clock "
                                   "budget per candidate rung task; a hung "
                                   "task is reaped and scored NaN. 0 prices "
                                   "the budget from core.perfmodel when "
                                   "confident, else no reaper", float, 0.0)
    maxAttempts = Param("maxAttempts", "Fit attempts per candidate before "
                        "its crash is terminal (scored NaN)", int, 2)
    rungTimeBudgetSeconds = Param("rungTimeBudgetSeconds", "Optional "
                                  "per-rung fit-time budget: the promotion "
                                  "quota is trimmed to what core.perfmodel "
                                  "predicts fits inside it. 0 disables",
                                  float, 0.0)
    perfJournal = Param("perfJournal", "Journal observed rung times as "
                        "automl_rung perfmodel training rows", bool, False)

    def _candidates(self) -> List[Dict[str, Any]]:
        space = self.paramSpace
        if self.searchMode == "grid":
            return list(GridSpace(space))
        return list(RandomSpace(space, self.numRuns, self.seed))

    @staticmethod
    def _candidate_key(params: Dict[str, Any]) -> str:
        """Stable identity of one candidate: sha256 over canonical JSON."""
        blob = json.dumps(params, sort_keys=True, default=repr)
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:24]

    def _fingerprint(self, df: Table, k: int, metric: str) -> Dict[str, Any]:
        """Search identity: resume records and bracket checkpoints are only
        valid against the same data, space, metric and fold count."""
        return {
            "data_rows": df.num_rows,
            "data_schema": {c: [str(np.asarray(df[c]).dtype),
                                list(np.asarray(df[c]).shape[1:])]
                            for c in sorted(df.columns)},
            "data_digest": _data_digest(df),
            "space": {name: _space_desc(spec)
                      for name, spec in (self.paramSpace or {}).items()},
            "metric": metric,
            "numFolds": k,
            "searchMode": self.searchMode,
            "numRuns": self.numRuns,
            "seed": self.seed,
            "labelCol": self.labelCol,
        }

    def _fit(self, df: Table) -> "TuneHyperparametersModel":
        candidates = self._candidates()
        keys = [self._candidate_key(p) for p in candidates]
        k = max(self.numFolds, 2)
        n = df.num_rows
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        folds = np.array_split(perm, k)
        metric = self.evaluationMetric
        maximize = metric in _MAXIMIZE

        fingerprint = self._fingerprint(df, k, metric)
        fp_digest = fingerprint_digest(fingerprint)

        ckpt_dir = self.checkpointDir or ""
        completed: Dict[str, float] = {}
        invalid: List[str] = []
        store = None
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
            completed, invalid = _load_candidate_records(ckpt_dir, fp_digest)
            store = CheckpointStore(os.path.join(ckpt_dir, "bracket"),
                                    keep_last=3)

        def run_folds(i: int, params: Dict[str, Any],
                      lo: int, hi: int) -> List[float]:
            if lo == 0:
                preemption_point("automl.candidate", i)
            scores = []
            for f in range(lo, hi):
                val_idx = folds[f]
                train_idx = np.concatenate(
                    [folds[j] for j in range(k) if j != f])
                est = self.model.copy(extra=params)
                fitted = est.fit(df.take(train_idx))
                scores.append(_evaluate(fitted, df.take(val_idx), metric,
                                        self.labelCol))
            return scores

        sch = ElasticHalvingScheduler(
            run_folds, candidates, keys,
            maximize=maximize, total_folds=k,
            eta=self.halvingEta, min_resource=self.minResourceFolds,
            parallelism=max(self.parallelism, 1),
            max_attempts=max(self.maxAttempts, 1),
            budget_s=self.candidateBudgetSeconds or None,
            rung_time_budget_s=self.rungTimeBudgetSeconds or None,
            store=store, fingerprint=fingerprint,
            completed=completed, invalidate=invalid,
            perf_features={"rows": float(n),
                           "cols": float(max(len(df.columns) - 1, 1))},
            perf_journal=bool(self.perfJournal))

        if ckpt_dir:
            def _journal_record(key: str, val: float, folds_done: int,
                                _params=sch.params) -> None:
                atomic_write_text(
                    os.path.join(ckpt_dir, f"cand_{key}.json"),
                    json.dumps({"params": _params[key], "metric": val,
                                "folds": folds_done,
                                "fingerprint": fp_digest}, default=repr))
            sch.on_candidate_done(_journal_record)

        by_key = sch.run()
        results = [by_key[key]["metric"] for key in keys]

        if np.all(np.isnan(results)):
            raise ValueError("every candidate scored NaN — check labels/folds "
                             "(candidate failures are counted under "
                             "automl.candidate_failure)")
        finalists = sch.finalists()
        if finalists:
            best_key = finalists[0]
            best_i = sch.first_index[best_key]
        else:
            # chaos killed every finalist: deterministic fallback to the
            # best partial score across the whole bracket
            best_i = int(np.nanargmax(results) if maximize
                         else np.nanargmin(results))
        best_params = candidates[best_i]
        best_model = self.model.copy(extra=best_params).fit(df)
        return TuneHyperparametersModel(
            bestModel=best_model, bestParams=best_params,
            bestMetric=float(results[best_i]),
            allResults=[{"params": c, "metric": r} for c, r in zip(candidates, results)])


class TuneHyperparametersModel(Model):
    bestModel = Param("bestModel", "Winning fitted model", object)
    bestParams = Param("bestParams", "Winning hyperparameters", object)
    bestMetric = Param("bestMetric", "Winning CV metric value", float)
    allResults = Param("allResults", "All (params, metric) results", list)

    def _transform(self, df: Table) -> Table:
        return self.bestModel.transform(df)

    def getBestModel(self):
        return self.bestModel

    def getBestModelInfo(self) -> dict:
        return {"params": self.bestParams, "metric": self.bestMetric}

    def _save_extra(self, path: str) -> None:
        import os
        if self.get("bestModel") is not None:
            self.bestModel.save(os.path.join(path, "bestModel"))

    def _load_extra(self, path: str) -> None:
        import os
        from ..core.pipeline import PipelineStage
        p = os.path.join(path, "bestModel")
        if os.path.isdir(p):
            self.set("bestModel", PipelineStage.load(p, self._load_device))


class FindBestModelResult(Model):
    bestModel = Param("bestModel", "Winning fitted model", object)
    allModelMetrics = Param("allModelMetrics", "Per-model metric values", list)

    def _transform(self, df: Table) -> Table:
        return self.bestModel.transform(df)

    def _save_extra(self, path: str) -> None:
        import os
        if self.get("bestModel") is not None:
            self.bestModel.save(os.path.join(path, "bestModel"))

    def _load_extra(self, path: str) -> None:
        import os
        from ..core.pipeline import PipelineStage
        p = os.path.join(path, "bestModel")
        if os.path.isdir(p):
            self.set("bestModel", PipelineStage.load(p, self._load_device))


class FindBestModel(Estimator, HasLabelCol):
    """Pick the best of several already-fitted models on an evaluation dataset
    (FindBestModel.scala). Evaluation is parallel and per-model isolated:
    one broken model scores NaN (``automl.model_failure``) instead of
    aborting the comparison — TuneHyperparameters candidate semantics."""
    models = Param("models", "Fitted Transformer list to compare", list)
    evaluationMetric = Param("evaluationMetric", "Metric name", str, "AUC")
    parallelism = Param("parallelism", "Concurrent model evaluations", int, 4)

    def _fit(self, df: Table) -> FindBestModelResult:
        models = self.models or []
        if not models:
            raise ValueError("FindBestModel requires a non-empty `models` list")
        metric = self.evaluationMetric
        maximize = metric in _MAXIMIZE

        def score_one(indexed) -> float:
            i, m = indexed
            try:
                return _evaluate(m, df, metric, self.labelCol)
            except Exception as e:  # noqa: BLE001 — per-model isolation
                record_failure("automl.model_failure", index=i,
                               model=type(m).__name__,
                               error=type(e).__name__, message=str(e)[:200])
                return float("nan")

        with ThreadPoolExecutor(
                max_workers=max(min(self.parallelism, len(models)), 1)) as ex:
            scores = list(ex.map(score_one, enumerate(models)))
        if np.all(np.isnan(scores)):
            raise ValueError("every model scored NaN — check labels/metric "
                             "(model failures are counted under "
                             "automl.model_failure)")
        best = models[int(np.nanargmax(scores) if maximize else np.nanargmin(scores))]
        return FindBestModelResult(
            bestModel=best,
            allModelMetrics=[{"model": type(m).__name__, "metric": s}
                             for m, s in zip(models, scores)])
