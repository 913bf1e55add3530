"""Ranking adapter, evaluator, and train/validation split.

A copy of the JAX package's ``recommendation/ranking.py`` (host numpy; the
port imports nothing of that package). Reference:
recommendation/RankingAdapter.scala, RankingEvaluator.scala
(AdvancedRankingMetrics:16-97), RankingTrainValidationSplit.scala. The adapter
turns a recommender into a Transformer that emits per-user ``prediction`` (top-k
recommended item indices) and ``label`` (actually-interacted item indices)
array columns; the evaluator computes ranking metrics over those columns; the
split does a per-user holdout and selects the best param map.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.params import Param, Params
from ..core.pipeline import Estimator, Model
from ..core.table import Table

_METRICS = ("ndcgAt", "map", "precisionAtk", "recallAtK", "diversityAtK",
            "maxDiversity", "mrr", "fcp")


class _RankingParams(Params):
    userCol = Param("userCol", "User index column", str, "user")
    itemCol = Param("itemCol", "Item index column", str, "item")
    ratingCol = Param("ratingCol", "Rating column", str, "rating")
    k = Param("k", "Number of recommendations", int, 10)


class RankingAdapter(Estimator, _RankingParams):
    """Wrap a recommender so fit/transform speak (prediction, label) arrays
    (reference RankingAdapter.scala: mode=allUsers)."""

    recommender = Param("recommender", "Underlying recommender estimator (SAR)",
                        is_complex=True)
    mode = Param("mode", "Recommendation mode", str, "allUsers")

    def _fit(self, df: Table) -> "RankingAdapterModel":
        rec = self.get("recommender")
        if rec is None:
            raise ValueError("RankingAdapter: recommender is not set")
        model = rec.copy().fit(df)
        passthrough = {p: self.get(p) for p in self._paramMap
                       if p != "recommender"}
        return RankingAdapterModel(recommenderModel=model, **passthrough)


class RankingAdapterModel(Model, _RankingParams):
    recommenderModel = Param("recommenderModel", "Fitted recommender",
                             is_complex=True)
    mode = Param("mode", "Recommendation mode", str, "allUsers")

    def _transform(self, df: Table) -> Table:
        model = self.get("recommenderModel")
        recs = model.recommend_for_user_subset(df, self.getK())
        rec_of = {int(u): list(map(int, r)) for u, r in
                  zip(recs[self.getUserCol()], recs["recommendations"])}
        users = np.asarray(df[self.getUserCol()], dtype=np.int64)
        items = np.asarray(df[self.getItemCol()], dtype=np.int64)
        truth: Dict[int, List[int]] = {}
        for u, i in zip(users, items):
            truth.setdefault(int(u), []).append(int(i))
        uniq = sorted(truth)
        pred = np.empty(len(uniq), dtype=object)
        label = np.empty(len(uniq), dtype=object)
        for r, u in enumerate(uniq):
            pred[r] = rec_of.get(u, [])
            label[r] = truth[u]
        return Table({self.getUserCol(): np.asarray(uniq),
                      "prediction": pred, "label": label})


class RankingEvaluator(Params):
    """Ranking metrics over (prediction, label) array columns.

    Reference: RankingEvaluator.scala / AdvancedRankingMetrics:24-97. Metrics:
    ndcgAt (binary relevance), map, precisionAtk, recallAtK, mrr,
    diversityAtK (#unique recommended / nItems), maxDiversity
    (#unique in labels ∪ recommendations / nItems), fcp (fraction of
    predicted-order pairs concordant with relevance).
    """

    metricName = Param("metricName", f"One of {_METRICS}", str, "ndcgAt",
                       validator=lambda v: v if v in _METRICS else
                       (_ for _ in ()).throw(ValueError(
                           f"metricName must be one of {_METRICS}, got {v!r}")))
    k = Param("k", "Cutoff for @k metrics", int, 10)
    nItems = Param("nItems", "Number of items (for diversity metrics)", int, -1)
    predictionCol = Param("predictionCol", "Prediction column", str, "prediction")
    labelCol = Param("labelCol", "Label column", str, "label")

    def isLargerBetter(self) -> bool:
        return True

    def evaluate(self, df: Table) -> float:
        return self.get_metrics(df)[self.getMetricName()]

    def get_metrics(self, df: Table) -> Dict[str, float]:
        preds = [list(p) for p in df[self.getPredictionCol()]]
        labels = [list(l) for l in df[self.getLabelCol()]]
        k = self.getK()
        ndcg, ap, prec, rec, mrr, fcp = [], [], [], [], [], []
        rec_items, lab_items = set(), set()
        for p, l in zip(preds, labels):
            lset = set(l)
            rec_items.update(p)
            lab_items.update(l)
            hits = [1.0 if x in lset else 0.0 for x in p]
            # ndcg@k (binary relevance)
            dcg = sum(h / np.log2(i + 2) for i, h in enumerate(hits[:k]))
            idcg = sum(1.0 / np.log2(i + 2) for i in range(min(k, len(lset))))
            ndcg.append(dcg / idcg if idcg > 0 else 0.0)
            # average precision (full list)
            got, ap_sum = 0, 0.0
            for i, h in enumerate(hits):
                if h:
                    got += 1
                    ap_sum += got / (i + 1.0)
            ap.append(ap_sum / max(len(lset), 1))
            prec.append(sum(hits[:k]) / float(k))
            rec.append(sum(hits[:k]) / max(len(lset), 1))
            mrr.append(next((1.0 / (i + 1) for i, h in enumerate(hits) if h), 0.0))
            pairs = concord = 0
            for i in range(len(hits)):
                for j in range(i + 1, len(hits)):
                    pairs += 1
                    concord += hits[i] >= hits[j]
            fcp.append(concord / pairs if pairs else 0.0)
        n_items = self.getNItems()
        if n_items <= 0:
            n_items = max(len(rec_items | lab_items), 1)
        return {
            "ndcgAt": float(np.mean(ndcg)) if ndcg else 0.0,
            "map": float(np.mean(ap)) if ap else 0.0,
            "mapk": float(np.mean(ap)) if ap else 0.0,
            "precisionAtk": float(np.mean(prec)) if prec else 0.0,
            "recallAtK": float(np.mean(rec)) if rec else 0.0,
            "mrr": float(np.mean(mrr)) if mrr else 0.0,
            "fcp": float(np.mean(fcp)) if fcp else 0.0,
            "diversityAtK": len(rec_items) / n_items,
            "maxDiversity": len(rec_items | lab_items) / n_items,
        }

    getMetrics = get_metrics


class RankingTrainValidationSplit(Estimator, _RankingParams):
    """Per-user holdout + grid search over a recommender's params
    (reference RankingTrainValidationSplit.scala)."""

    estimator = Param("estimator", "Recommender estimator", is_complex=True)
    evaluator = Param("evaluator", "RankingEvaluator", is_complex=True)
    estimatorParamMaps = Param("estimatorParamMaps",
                               "list of {param: value} dicts", is_complex=True)
    trainRatio = Param("trainRatio", "Fraction of each user's rows for training",
                       float, 0.75)
    seed = Param("seed", "Split seed", int, 0)

    def _split(self, df: Table):
        users = np.asarray(df[self.getUserCol()], dtype=np.int64)
        rng = np.random.default_rng(self.getSeed())
        train_mask = np.zeros(len(users), dtype=bool)
        for u in np.unique(users):
            idx = np.flatnonzero(users == u)
            n_train = max(1, int(round(len(idx) * self.getTrainRatio())))
            chosen = rng.permutation(idx)[:n_train]
            train_mask[chosen] = True
        return df.take(np.flatnonzero(train_mask)), df.take(np.flatnonzero(~train_mask))

    def _fit(self, df: Table) -> "RankingTrainValidationSplitModel":
        est = self.get("estimator")
        ev: RankingEvaluator = self.get("evaluator") or RankingEvaluator()
        grids: List[dict] = self.get("estimatorParamMaps") or [{}]
        train, val = self._split(df)
        results = []
        for grid in grids:
            adapter = RankingAdapter(
                recommender=est.copy(grid), k=ev.getK(),
                userCol=self.getUserCol(), itemCol=self.getItemCol(),
                ratingCol=self.getRatingCol())
            model = adapter.fit(train)
            metric = ev.evaluate(model.transform(val))
            results.append((metric, grid, model))
        results.sort(key=lambda r: r[0], reverse=ev.isLargerBetter())
        best_metric, best_grid, best_model = results[0]
        return RankingTrainValidationSplitModel(
            bestModel=best_model, validationMetrics=[r[0] for r in results],
            bestParams=best_grid, bestMetric=best_metric)


class RankingTrainValidationSplitModel(Model):
    bestModel = Param("bestModel", "Best fitted RankingAdapterModel", is_complex=True)
    validationMetrics = Param("validationMetrics", "Metric per grid", is_complex=True)
    bestParams = Param("bestParams", "Winning param map", is_complex=True)
    bestMetric = Param("bestMetric", "Winning metric value", float)

    def _transform(self, df: Table) -> Table:
        return self.get("bestModel").transform(df)
