"""VowpalWabbit estimator surface.

Reference classes (vw/src/main/scala/.../vw/): VowpalWabbitClassifier.scala,
VowpalWabbitRegressor.scala, VowpalWabbitGeneric.scala,
VowpalWabbitGenericProgressive.scala, VowpalWabbitContextualBandit.scala, all on
VowpalWabbitBase.scala (arg building) + VowpalWabbitBaseLearner.scala
(distributed training loop). The native learn/predict JNI calls become the
port's engine in learner.py; `passThroughArgs` parses the common VW CLI flags.

The port's counterpart of the JAX package's ``vw/estimators.py``: the same
params, plus ``device`` (default ``"cuda"``), where the learner's state lives,
trains and scores (a ``mesh`` attribute trains on the mesh's device)."""

from __future__ import annotations

from dataclasses import replace as _replace
from typing import Optional, Tuple

import numpy as np

from ..core.device import DEFAULT_DEVICE
from ..core.params import (Param, HasFeaturesCol, HasLabelCol, HasWeightCol,
                           HasPredictionCol, HasProbabilityCol, HasRawPredictionCol)
from ..core.pipeline import Estimator, Model, Transformer
from ..core.table import Table
from .learner import (SPARSE_DTYPE, VWConfig, VWState, make_sparse_batch,
                      train_vw, vw_predict)
from .textparse import parse_lines


def _flatten_action_rows(actions, shared_row=None):
    """Drop zero-value slots from each action's sparse row and append the
    shared-context features (used by both CB fit and CB transform)."""
    idxs, vals = [], []
    if shared_row is not None:
        shared_row = np.asarray(shared_row)
        s_live = shared_row["val"] != 0
        s_ix = list(shared_row["idx"][s_live])
        s_vv = list(shared_row["val"][s_live])
    else:
        s_ix, s_vv = [], []
    for a_row in actions:
        a_row = np.asarray(a_row)
        live = a_row["val"] != 0
        idxs.append(list(a_row["idx"][live]) + s_ix)
        vals.append(list(a_row["val"][live]) + s_vv)
    return idxs, vals


class _HasDevice:
    device = Param("device", "Device that trains and scores the learner: "
                   "'cuda' (default) or 'cpu'", str, DEFAULT_DEVICE)


class _VWParams(HasFeaturesCol, HasLabelCol, HasWeightCol, HasPredictionCol,
                _HasDevice):
    """Shared arg surface (VowpalWabbitBase.scala:213+)."""
    numBits = Param("numBits", "Hash bits (-b)", int, 18)
    learningRate = Param("learningRate", "Learning rate (-l)", float, 0.5)
    powerT = Param("powerT", "t power value (--power_t)", float, 0.5)
    initialT = Param("initialT", "Initial t (--initial_t)", float, 0.0)
    l1 = Param("l1", "L1 regularization (--l1)", float, 0.0)
    l2 = Param("l2", "L2 regularization (--l2)", float, 0.0)
    numPasses = Param("numPasses", "Number of passes over the data", int, 1)
    hashSeed = Param("hashSeed", "Hash seed (--hash_seed)", int, 0)
    ignoreNamespaces = Param("ignoreNamespaces", "Namespaces to ignore (--ignore)", str)
    interactions = Param("interactions", "Namespace interactions (-q)", list)
    useBarrierExecutionMode = Param(
        "useBarrierExecutionMode", "Gang scheduling (no-op: the mesh's ranks "
        "always run together)", bool, False)
    numSyncsPerPass = Param(
        "numSyncsPerPass", "Weight-averaging AllReduce segments per pass "
        "(VowpalWabbitSyncScheduleSplits)", int, 1)
    passThroughArgs = Param("passThroughArgs", "Raw VW-style argument string", str, "")
    initialModel = Param("initialModel", "Warm-start weights (serialized VWState)", bytes)
    batchSize = Param("batchSize", "Examples per update step", int, 256)

    def _config(self, loss: str, **overrides) -> VWConfig:
        cfg = VWConfig(num_bits=self.numBits, learning_rate=self.learningRate,
                       power_t=self.powerT, initial_t=self.initialT,
                       l1=self.l1, l2=self.l2, loss_function=loss,
                       num_passes=self.numPasses, batch_size=self.batchSize,
                       hash_seed=self.hashSeed, sync_splits=max(self.numSyncsPerPass, 1),
                       **overrides)
        return self._apply_pass_through(cfg)

    def _apply_pass_through(self, cfg: VWConfig) -> VWConfig:
        """Parse the common VW CLI flags out of passThroughArgs — the escape
        hatch users rely on in the reference (VowpalWabbitBase passThroughArgs)."""
        args = (self.passThroughArgs or "").split()
        updates = {}
        flag_map = {"-b": ("num_bits", int), "--bit_precision": ("num_bits", int),
                    "-l": ("learning_rate", float), "--learning_rate": ("learning_rate", float),
                    "--power_t": ("power_t", float), "--initial_t": ("initial_t", float),
                    "--l1": ("l1", float), "--l2": ("l2", float),
                    "--passes": ("num_passes", int),
                    "--loss_function": ("loss_function", str),
                    "--quantile_tau": ("quantile_tau", float),
                    "--cb_type": ("cb_type", str)}
        i = 0
        while i < len(args):
            a = args[i]
            if a in flag_map and i + 1 < len(args):
                k, typ = flag_map[a]
                updates[k] = typ(args[i + 1])
                i += 2
            elif a == "--noconstant":
                updates["no_constant"] = True
                i += 1
            elif a == "--adaptive":
                updates["adaptive"] = True
                i += 1
            elif a == "--sgd":
                updates["adaptive"] = False
                i += 1
            else:
                i += 1
        if self.get("hashSeed"):
            updates["hash_seed"] = self.hashSeed
        return _replace(cfg, **updates) if updates else cfg

    def _interaction_pairs(self) -> Tuple[str, ...]:
        """Namespace interactions from the `interactions` param plus every
        accepted CLI form in passThroughArgs: '-qab', '-q ab', '--interactions ab',
        '--quadratic ab'."""
        pairs = list(self.get("interactions") or [])
        args = (self.passThroughArgs or "").split()
        i = 0
        while i < len(args):
            a = args[i]
            if a.startswith("-q") and len(a) > 2:
                pairs.append(a[2:])
                i += 1
            elif a in ("-q", "--quadratic", "--interactions") and i + 1 < len(args):
                pairs.append(args[i + 1])
                i += 2
            else:
                i += 1
        return tuple(dict.fromkeys(pairs))

    def _sparse_features(self, df: Table):
        a = df[self.featuresCol]
        if a.dtype == SPARSE_DTYPE:
            return np.ascontiguousarray(a["idx"]), np.ascontiguousarray(a["val"])
        if a.ndim == 2:  # dense vector column → implicit identity "hashing"
            mask = (1 << self.numBits) - 1
            n, d = a.shape
            idx = np.broadcast_to(np.arange(d, dtype=np.int32) & mask, (n, d))
            return np.ascontiguousarray(idx), np.asarray(a, np.float32)
        raise ValueError(f"features column {self.featuresCol!r} must be a sparse "
                         "(VowpalWabbitFeaturizer) or dense 2-D column")

    def _weights(self, df: Table):
        wc = self.get("weightCol")
        return np.asarray(df[wc], np.float32) if wc and wc in df else None

    def _train_device(self):
        """The mesh's device when the estimator carries a ``mesh``, else
        its ``device`` param."""
        mesh = getattr(self, "mesh", None)
        return mesh.device if mesh is not None else self.device

    def _initial_state(self) -> Optional[VWState]:
        """Warm start from serialized model bytes (VW `initialModel` param,
        VowpalWabbitBaseLearner.scala:180-182)."""
        raw = self.get("initialModel")
        return VWState.from_bytes(raw, self._train_device()) if raw else None


class _VWModelBase(Model, HasFeaturesCol, HasPredictionCol, _HasDevice):
    numBits = Param("numBits", "Hash bits", int, 18)

    def __init__(self, state: Optional[VWState] = None, **kwargs):
        super().__init__(**kwargs)
        self.state = state

    def _save_extra(self, path: str) -> None:
        import os
        if self.state is not None:
            with open(os.path.join(path, "vw_state.npz"), "wb") as f:
                f.write(self.state.to_bytes())

    def _load_extra(self, path: str) -> None:
        import os
        f = os.path.join(path, "vw_state.npz")
        if os.path.exists(f):
            with open(f, "rb") as fh:
                self.state = VWState.from_bytes(fh.read(), self.device)

    def getPerformanceStatistics(self) -> dict:
        """TrainingStats analog (VowpalWabbitBaseLearner.scala:20-40)."""
        st = self.state
        return {"progressiveLoss": st.progressive_loss if st else None,
                "examples": float(st.weight_sum) if st else 0.0}

    def _features(self, df: Table):
        a = df[self.featuresCol]
        if a.dtype == SPARSE_DTYPE:
            return a["idx"], a["val"]
        if a.ndim == 2:
            n, d = a.shape
            mask = (1 << self.numBits) - 1
            return (np.broadcast_to(np.arange(d, dtype=np.int32) & mask, (n, d)),
                    np.asarray(a, np.float32))
        raise ValueError("bad features column")


class VowpalWabbitClassifier(Estimator, _VWParams, HasProbabilityCol, HasRawPredictionCol):
    """Binary classifier, logistic loss on ±1 labels (VowpalWabbitClassifier.scala)."""
    labelConversion = Param("labelConversion", "Convert 0/1 labels to -1/1", bool, True)

    def _fit(self, df: Table) -> "VowpalWabbitClassificationModel":
        idx, val = self._sparse_features(df)
        y = np.asarray(df[self.labelCol], np.float32)
        if self.labelConversion:
            y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
        cfg = self._config("logistic")
        state, _ = train_vw(idx, val, y, cfg, sample_weight=self._weights(df),
                            mesh=getattr(self, "mesh", None),
                            initial_state=self._initial_state(),
                            device=self._train_device())
        m = VowpalWabbitClassificationModel(
            state=state, device=str(state.device), numBits=cfg.num_bits,
            featuresCol=self.featuresCol,
            predictionCol=self.predictionCol, probabilityCol=self.probabilityCol,
            rawPredictionCol=self.rawPredictionCol)
        return m


class VowpalWabbitClassificationModel(_VWModelBase, HasProbabilityCol, HasRawPredictionCol):
    def _transform(self, df: Table) -> Table:
        idx, val = self._features(df)
        raw = vw_predict(self.state, idx, val)
        prob = 1.0 / (1.0 + np.exp(-raw))
        out = df.with_column(self.rawPredictionCol, raw)
        out = out.with_column(self.probabilityCol, np.stack([1 - prob, prob], 1))
        return out.with_column(self.predictionCol, (prob > 0.5).astype(np.float32))


class VowpalWabbitRegressor(Estimator, _VWParams):
    """Squared/quantile-loss regressor (VowpalWabbitRegressor.scala)."""
    lossFunction = Param("lossFunction", "squared | quantile", str, "squared")

    def _fit(self, df: Table) -> "VowpalWabbitRegressionModel":
        idx, val = self._sparse_features(df)
        y = np.asarray(df[self.labelCol], np.float32)
        cfg = self._config(self.lossFunction)
        state, _ = train_vw(idx, val, y, cfg, sample_weight=self._weights(df),
                            mesh=getattr(self, "mesh", None),
                            initial_state=self._initial_state(),
                            device=self._train_device())
        return VowpalWabbitRegressionModel(
            state=state, device=str(state.device), numBits=cfg.num_bits,
            featuresCol=self.featuresCol,
            predictionCol=self.predictionCol)


class VowpalWabbitRegressionModel(_VWModelBase):
    def _transform(self, df: Table) -> Table:
        idx, val = self._features(df)
        return df.with_column(self.predictionCol, vw_predict(self.state, idx, val))


class VowpalWabbitGeneric(Estimator, _VWParams):
    """Learns from raw VW text lines in ``inputCol`` (VowpalWabbitGeneric.scala)."""
    inputCol = Param("inputCol", "Column of VW-format text examples", str, "value")

    def _fit(self, df: Table) -> "VowpalWabbitGenericModel":
        cfg = self._config("logistic" if "logistic" in (self.passThroughArgs or "")
                           else "squared")
        inter = self._interaction_pairs()
        ignore = self.get("ignoreNamespaces") or ""
        sp, y, w = parse_lines(df[self.inputCol], cfg.num_bits, inter,
                               cfg.hash_seed, ignore)
        y = np.nan_to_num(y)
        if cfg.loss_function in ("logistic", "hinge"):
            y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
        state, _ = train_vw(np.ascontiguousarray(sp["idx"]), np.ascontiguousarray(sp["val"]),
                            y, cfg, sample_weight=w, mesh=getattr(self, "mesh", None),
                            initial_state=self._initial_state(),
                            device=self._train_device())
        return VowpalWabbitGenericModel(
            state=state, device=str(state.device), numBits=cfg.num_bits,
            inputCol=self.inputCol,
            predictionCol=self.predictionCol, _loss=cfg.loss_function,
            _interactions=list(inter), _hashSeed=cfg.hash_seed,
            _ignoreNamespaces=ignore)


class VowpalWabbitGenericModel(_VWModelBase):
    inputCol = Param("inputCol", "Column of VW-format text examples", str, "value")
    _loss = Param("_loss", "loss used at fit time", str, "squared")
    _interactions = Param("_interactions", "interaction pairs used at fit time", list)
    _hashSeed = Param("_hashSeed", "hash seed used at fit time", int, 0)
    _ignoreNamespaces = Param("_ignoreNamespaces", "ignored namespaces at fit time", str, "")

    def _transform(self, df: Table) -> Table:
        sp, _, _ = parse_lines(df[self.inputCol], self.numBits,
                               tuple(self.get("_interactions") or ()),
                               self._hashSeed, self._ignoreNamespaces or "")
        link = "logistic" if self._loss == "logistic" else "identity"
        pred = vw_predict(self.state, sp["idx"], sp["val"], link=link)
        return df.with_column(self.predictionCol, pred)


class VowpalWabbitGenericProgressive(Transformer, _VWParams):
    """One progressive-validation pass: transform() returns the pre-update
    prediction for every example (VowpalWabbitGenericProgressive.scala)."""
    inputCol = Param("inputCol", "Column of VW-format text examples", str, "value")

    def _transform(self, df: Table) -> Table:
        cfg = self._config("logistic" if "logistic" in (self.passThroughArgs or "")
                           else "squared")
        sp, y, w = parse_lines(df[self.inputCol], cfg.num_bits,
                               self._interaction_pairs(), cfg.hash_seed,
                               self.get("ignoreNamespaces") or "")
        y = np.nan_to_num(y)
        if cfg.loss_function in ("logistic", "hinge"):
            y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
        _, prog = train_vw(np.ascontiguousarray(sp["idx"]), np.ascontiguousarray(sp["val"]),
                           y, cfg, sample_weight=w, collect_progressive=True,
                           device=self.device)
        return df.with_column(self.predictionCol, prog[: df.num_rows])


class VowpalWabbitContextualBandit(Estimator, _VWParams):
    """Contextual bandit on logged (action, cost, probability) data
    (VowpalWabbitContextualBandit.scala). Cost regression per action with
    cb_type ips (importance-weighted) or mtr (regression on chosen action)."""
    sharedCol = Param("sharedCol", "Shared-context sparse features column", str, "shared")
    featuresCol = Param("featuresCol", "Per-action sparse features column "
                        "(object column: list of SPARSE rows per example)", str, "features")
    chosenActionCol = Param("chosenActionCol", "1-based chosen action index column", str, "chosenAction")
    probabilityCol = Param("probabilityCol", "Logged probability column", str, "probability")
    labelCol = Param("labelCol", "Cost column", str, "label")
    epsilon = Param("epsilon", "Exploration epsilon for output policy", float, 0.05)
    cbType = Param("cbType", "ips | mtr", str, "ips")

    def _fit(self, df: Table) -> "VowpalWabbitContextualBanditModel":
        feats = df[self.featuresCol]
        shared = df[self.sharedCol] if self.get("sharedCol") and self.sharedCol in df else None
        chosen = np.asarray(df[self.chosenActionCol], np.int64)   # 1-based
        cost = np.asarray(df[self.labelCol], np.float32)
        prob = np.asarray(df[self.probabilityCol], np.float32)

        # training rows = chosen action's features of each example
        idxs, vals = [], []
        for i in range(df.num_rows):
            actions = feats[i]
            if not (1 <= chosen[i] <= len(actions)):
                raise ValueError(
                    f"chosenAction out of range for example {i}: got {chosen[i]}, "
                    f"expected 1..{len(actions)} (chosenActionCol is 1-based)")
            ix, vv = _flatten_action_rows([actions[chosen[i] - 1]],
                                          shared[i] if shared is not None else None)
            idxs.append(ix[0])
            vals.append(vv[0])
        sp = make_sparse_batch(idxs, vals)
        y = cost
        w = np.ones(df.num_rows, np.float32)
        if self.cbType == "ips":
            w = 1.0 / np.maximum(prob, 1e-6)
        cfg = self._config("squared", cb_type=self.cbType)
        state, _ = train_vw(np.ascontiguousarray(sp["idx"]),
                            np.ascontiguousarray(sp["val"]),
                            y, cfg, sample_weight=w, mesh=getattr(self, "mesh", None),
                            initial_state=self._initial_state(),
                            device=self._train_device())
        return VowpalWabbitContextualBanditModel(
            state=state, device=str(state.device), numBits=cfg.num_bits,
            featuresCol=self.featuresCol,
            sharedCol=self.get("sharedCol"), predictionCol=self.predictionCol,
            epsilon=self.epsilon)


class VowpalWabbitContextualBanditModel(_VWModelBase):
    sharedCol = Param("sharedCol", "Shared-context features column", str, "shared")
    epsilon = Param("epsilon", "Exploration epsilon", float, 0.05)

    def _transform(self, df: Table) -> Table:
        feats = df[self.featuresCol]
        shared = df[self.sharedCol] if self.get("sharedCol") and self.sharedCol in df else None
        probs_out, action_out, scores_out = [], [], []
        for i in range(df.num_rows):
            actions = feats[i]
            idxs, vals = _flatten_action_rows(
                actions, shared[i] if shared is not None else None)
            sp = make_sparse_batch(idxs, vals)
            scores = vw_predict(self.state, sp["idx"], sp["val"])
            k = len(scores)
            best = int(np.argmin(scores))
            p = np.full(k, self.epsilon / k, np.float32)
            p[best] += 1.0 - self.epsilon
            probs_out.append(p)
            action_out.append(best + 1)
            scores_out.append(scores)
        out = df.with_column(self.predictionCol, np.asarray(probs_out, object))
        out = out.with_column("chosenActionPrediction", np.asarray(action_out, np.int64))
        return out.with_column("scores", np.asarray(scores_out, object))
