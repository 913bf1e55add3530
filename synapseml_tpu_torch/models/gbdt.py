"""LightGBM-capability estimators: Classifier / Regressor / Ranker on the
port's engine.

Counterpart of the JAX package's ``models/gbdt.py`` for the ported slice:
binary and multiclass classification, regression with every LightGBM
regression objective, and LambdaRank ranking, with every boosting type
(gbdt, goss, dart, rf) on numeric and categorical features
(``categoricalSlotIndexes``, or ``categoricalSlotNames`` resolved through
``slotNames``, with ``catSmooth``, ``catl2``, ``maxCatThreshold``,
``maxCatToOnehot`` and ``minDataPerGroup``); bagging (``baggingFraction``,
``baggingFreq``, ``baggingSeed``, stratified ``pos``/``negBaggingFraction``),
feature fractions per tree and per node with their seed, DART's
``dropRate``, ``maxDrop``, ``skipDrop``, ``uniformDrop``, ``dropSeed`` and
``xGBoostDartMode``, GOSS's ``topRate``/``otherRate``, ``extraSeed``,
``monotoneConstraints`` (each split on a constrained feature orders its
two children's outputs, as in the JAX package; ``monotoneConstraintsMethod``
and ``monotonePenalty`` are accepted and inert there and here);
validation rows (``validationIndicatorCol``)
with the metric and early stopping, warm starts (``modelString``, and
``numBatches`` sequential batches each warm-started from the last), custom
objectives (``fobj``), the prediction window (``startIteration``) and the
leaf-index and SHAP output columns, and the distributed learners' params
(``parallelism``: ``data_parallel``, ``voting_parallel``,
``feature_parallel`` or ``auto``, with ``topK``), mapped to
``tree_learner`` and ``top_k`` as in the JAX package; the estimators pass no
mesh, so, as there, every learner trains the serial trees (a mesh is
``gbdt.train_booster``'s). camelCase param names match the reference so
code ports 1:1; every param of the JAX estimators is declared.
The JAX ranker takes ``modelString`` and
``numBatches`` but does not use them; the port's ranker refuses them
instead. The Spark/JNI plumbing params stay accepted as no-ops, as in the
JAX package.

``device`` (default ``"cuda"``) is where the booster trains and scores; a
missing card raises rather than falling back to the CPU.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..core import (Estimator, HasFeaturesCol, HasGroupCol, HasInitScoreCol,
                    HasLabelCol, HasPredictionCol, HasProbabilityCol,
                    HasRawPredictionCol, HasValidationIndicatorCol,
                    HasWeightCol, Model, Param, Table, feature_matrix)
from ..core.device import DEFAULT_DEVICE
from ..gbdt.boosting import Booster, BoosterConfig, train_booster

# params of the JAX estimator that the port does not implement (none)
UNPORTED_PARAMS = frozenset()


class _DeviceParam:
    device = Param("device", "Device that trains and scores the booster: "
                   "'cuda' (default) or 'cpu'", str, DEFAULT_DEVICE)


class _LightGBMParams(HasFeaturesCol, HasLabelCol, HasWeightCol,
                      HasValidationIndicatorCol, HasInitScoreCol,
                      HasPredictionCol, _DeviceParam):
    # core boosting params (defaults = LightGBM defaults, as in the reference)
    numIterations = Param("numIterations", "Number of boosting iterations", int, 100)
    learningRate = Param("learningRate", "Shrinkage rate", float, 0.1)
    numLeaves = Param("numLeaves", "Max leaves per tree", int, 31)
    maxBin = Param("maxBin", "Max number of feature bins", int, 255)
    maxDepth = Param("maxDepth", "Max tree depth (-1 = unlimited)", int, -1)
    boostingType = Param("boostingType", "gbdt, rf, dart or goss", str, "gbdt")
    lambdaL1 = Param("lambdaL1", "L1 regularization", float, 0.0)
    lambdaL2 = Param("lambdaL2", "L2 regularization", float, 0.0)
    minDataInLeaf = Param("minDataInLeaf", "Min rows per leaf", int, 20)
    minSumHessianInLeaf = Param("minSumHessianInLeaf", "Min hessian sum per leaf", float, 1e-3)
    minGainToSplit = Param("minGainToSplit", "Min gain to perform a split", float, 0.0)
    baggingFraction = Param("baggingFraction", "Row subsample fraction", float, 1.0)
    baggingFreq = Param("baggingFreq", "Resample bagging every k iterations (0=off)", int, 0)
    baggingSeed = Param("baggingSeed", "Bagging seed", int, 3)
    featureFraction = Param("featureFraction", "Feature subsample fraction per tree", float, 1.0)
    featureFractionByNode = Param("featureFractionByNode", "Feature subsample fraction per node", float, 1.0)
    posBaggingFraction = Param("posBaggingFraction", "Positive-class bagging fraction", float, 1.0)
    negBaggingFraction = Param("negBaggingFraction", "Negative-class bagging fraction", float, 1.0)
    dropRate = Param("dropRate", "DART tree drop probability", float, 0.1)
    maxDrop = Param("maxDrop", "DART max trees dropped per iteration", int, 50)
    skipDrop = Param("skipDrop", "DART probability of skipping dropout", float, 0.5)
    uniformDrop = Param("uniformDrop", "DART uniform drop", bool, False)
    topRate = Param("topRate", "GOSS large-gradient keep fraction", float, 0.2)
    otherRate = Param("otherRate", "GOSS small-gradient sample fraction", float, 0.1)
    monotoneConstraints = Param("monotoneConstraints", "Per-feature -1/0/+1 constraints", list)
    monotoneConstraintsMethod = Param("monotoneConstraintsMethod", "basic/intermediate/advanced (inert, as in the JAX package)", str, "basic")
    monotonePenalty = Param("monotonePenalty", "Monotone split penalty (inert)", float, 0.0)
    categoricalSlotIndexes = Param("categoricalSlotIndexes", "Categorical feature indices", list)
    categoricalSlotNames = Param("categoricalSlotNames", "Categorical feature names", list)
    catSmooth = Param("catSmooth", "Categorical smoothing", float, 10.0)
    maxCatThreshold = Param("maxCatThreshold", "Max categories on one split side", int, 32)
    catl2 = Param("catl2", "Extra L2 applied to categorical split gains",
                  float, 10.0)
    maxCatToOnehot = Param("maxCatToOnehot", "One-vs-rest categorical splits "
                           "at or below this many categories", int, 4)
    minDataPerGroup = Param("minDataPerGroup", "Minimum rows per categorical "
                            "group considered for splitting", int, 100)
    dropSeed = Param("dropSeed", "DART drop-selection seed (0 = derive from "
                     "seed)", int, 0)
    featureFractionSeed = Param("featureFractionSeed", "Feature-sampling seed "
                                "(0 = derive from seed)", int, 0)
    extraSeed = Param("extraSeed", "Extra sampling seed (0 = derive from "
                      "seed)", int, 0)
    xGBoostDartMode = Param("xGBoostDartMode", "XGBoost-style DART "
                            "normalization (learning-rate weighted)", bool,
                            False)
    maxDeltaStep = Param("maxDeltaStep", "Max absolute leaf output", float, 0.0)
    earlyStoppingRound = Param("earlyStoppingRound", "Early stopping patience (0=off)", int, 0)
    improvementTolerance = Param("improvementTolerance", "Min metric improvement", float, 0.0)
    metric = Param("metric", "Eval metric for validation", str)
    slotNames = Param("slotNames", "Feature names", list)
    seed = Param("seed", "Main random seed", int, 0)
    objectiveSeed = Param("objectiveSeed", "Objective seed", int, 5)
    dataRandomSeed = Param("dataRandomSeed", "Data random seed", int, 1)
    boostFromAverage = Param("boostFromAverage", "Initialize score to label average", bool, True)
    numBatches = Param("numBatches", "Split training into N sequential "
                       "warm-started batches", int, 0)
    modelString = Param("modelString", "Initial model string to continue "
                        "training from", str)
    binSampleCount = Param("binSampleCount", "Rows sampled for bin boundaries", int, 200000)
    verbosity = Param("verbosity", "Verbosity", int, -1)
    leafPredictionCol = Param("leafPredictionCol", "Output column for leaf indices", str)
    featuresShapCol = Param("featuresShapCol", "Output column for SHAP values", str)
    predictDisableShapeCheck = Param("predictDisableShapeCheck", "Disable shape check at predict", bool, False)
    passThroughArgs = Param("passThroughArgs", "Raw LightGBM-style 'key=value' args overriding params", str)
    # Spark/JNI-plumbing compat no-ops (as in the JAX package)
    useBarrierExecutionMode = Param("useBarrierExecutionMode", "no-op", bool, False)
    useSingleDatasetMode = Param("useSingleDatasetMode", "no-op", bool, True)
    executionMode = Param("executionMode", "no-op", str, "streaming")
    dataTransferMode = Param("dataTransferMode", "no-op", str, "streaming")
    numTasks = Param("numTasks", "no-op", int, 0)
    numThreads = Param("numThreads", "no-op", int, 0)
    chunkSize = Param("chunkSize", "no-op", int, 10000)
    matrixType = Param("matrixType", "no-op (auto)", str, "auto")
    defaultListenPort = Param("defaultListenPort", "no-op", int, 12400)
    driverListenPort = Param("driverListenPort", "no-op", int, 0)
    timeout = Param("timeout", "no-op", float, 1200.0)
    maxStreamingOMPThreads = Param("maxStreamingOMPThreads", "no-op", int, 16)
    microBatchSize = Param("microBatchSize", "no-op", int, 100)
    topK = Param("topK", "Voting-parallel top-K (distributed histogram "
                 "vote)", int, 20)
    parallelism = Param("parallelism", "data_parallel, voting_parallel, "
                        "feature_parallel or auto (LightGBMParams.scala:"
                        "25-29)", str, "data_parallel")
    isProvideTrainingMetric = Param("isProvideTrainingMetric", "Log training metrics", bool, False)
    deterministic = Param("deterministic", "Deterministic training", bool, False)
    isEnableSparse = Param("isEnableSparse", "Enable sparse optimization", bool, True)
    minDataPerBin = Param("minDataPerBin", "Minimum sample rows per bin "
                          "(under-filled bins merge)", int, 3)
    maxBinByFeature = Param("maxBinByFeature", "Per-feature max bin counts",
                            list, None)
    samplingSubsetSize = Param("samplingSubsetSize", "Boundary-sample size "
                               "when subset sampling; 0 defers to "
                               "binSampleCount", int, 0)
    repartitionByGroupingColumn = Param("repartitionByGroupingColumn",
                                        "Kept for API parity", bool, True)
    referenceDataset = Param("referenceDataset", "Precomputed BinMapper (or "
                             "gbdt.Dataset) reused for binning",
                             is_complex=True)
    useMissing = Param("useMissing", "Handle missing values specially", bool, True)
    zeroAsMissing = Param("zeroAsMissing", "Treat zero as missing", bool, False)
    startIteration = Param("startIteration", "First boosting round used at "
                           "prediction time", int, 0)
    fobj = Param("fobj", "Custom objective: fn(score, label, weight) -> "
                 "(grad, hess), torch tensors on the fit device (see "
                 "gbdt.train_booster)", is_complex=True)

    def _reference_mapper(self, X=None):
        """referenceDataset param → BinMapper (accepts a Dataset too); with
        ``X``, every feature carrying NaN must have a missing bin."""
        ref = self.get("referenceDataset")
        if ref is None:
            return None
        mapper = getattr(ref, "mapper", ref)
        if X is not None:
            need = np.isnan(np.asarray(X)).any(axis=0)
            have = np.asarray(mapper.nan_mask)
            bad = np.flatnonzero(need[: len(have)] & ~have)
            if bad.size:
                raise ValueError(
                    "referenceDataset's bin mapper has no missing bin for "
                    f"feature(s) {bad.tolist()} that contain missing values "
                    "after useMissing/zeroAsMissing preprocessing; build the "
                    "reference dataset from identically-preprocessed data")
        return mapper

    def _base_config(self, **overrides) -> BoosterConfig:
        cfg = BoosterConfig(
            num_iterations=self.getNumIterations(),
            learning_rate=self.getLearningRate(),
            num_leaves=self.getNumLeaves(),
            max_bin=self.getMaxBin(),
            max_depth=self.getMaxDepth(),
            boosting_type=self.getBoostingType(),
            lambda_l1=self.getLambdaL1(),
            lambda_l2=self.getLambdaL2(),
            min_data_in_leaf=self.getMinDataInLeaf(),
            min_sum_hessian_in_leaf=self.getMinSumHessianInLeaf(),
            min_gain_to_split=self.getMinGainToSplit(),
            bagging_fraction=self.getBaggingFraction(),
            bagging_freq=self.getBaggingFreq(),
            feature_fraction=self.getFeatureFraction(),
            feature_fraction_bynode=self.getFeatureFractionByNode(),
            pos_bagging_fraction=self.getPosBaggingFraction(),
            neg_bagging_fraction=self.getNegBaggingFraction(),
            drop_rate=self.getDropRate(),
            max_drop=self.getMaxDrop(),
            skip_drop=self.getSkipDrop(),
            uniform_drop=self.getUniformDrop(),
            top_rate=self.getTopRate(),
            other_rate=self.getOtherRate(),
            monotone_constraints=self.get("monotoneConstraints"),
            drop_seed=self.getDropSeed(),
            feature_fraction_seed=self.getFeatureFractionSeed(),
            extra_seed=self.getExtraSeed(),
            bagging_seed=self.getBaggingSeed(),
            xgboost_dart_mode=self.getXGBoostDartMode(),
            max_delta_step=self.getMaxDeltaStep(),
            cat_smooth=self.getCatSmooth(),
            cat_l2=self.getCatl2(),
            max_cat_threshold=self.getMaxCatThreshold(),
            max_cat_to_onehot=self.getMaxCatToOnehot(),
            min_data_per_group=self.getMinDataPerGroup(),
            early_stopping_round=self.getEarlyStoppingRound(),
            metric=self.get("metric"),
            improvement_tolerance=self.getImprovementTolerance(),
            start_iteration=self.getStartIteration(),
            seed=self.getSeed(),
            boost_from_average=self.getBoostFromAverage(),
            bin_sample_count=(self.getSamplingSubsetSize()
                              or self.getBinSampleCount()),
            min_data_in_bin=self.getMinDataPerBin(),
            max_bin_by_feature=self.get("maxBinByFeature"),
            data_random_seed=(self.get("dataRandomSeed")
                              if self.isSet("dataRandomSeed") else None),
            zero_as_missing=(bool(self.get("zeroAsMissing"))
                             and bool(self.get("useMissing"))),
            tree_learner={"voting_parallel": "voting",
                          "feature_parallel": "feature",
                          "auto": "auto"}.get(self.getParallelism(), "data"),
            top_k=self.getTopK(),
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        self._apply_pass_through(cfg)
        return cfg

    def _apply_pass_through(self, cfg: BoosterConfig) -> None:
        """passThroughArgs: 'k1=v1 k2=v2' raw overrides (LightGBMParams.scala);
        ``train_booster`` rejects any that select an unported feature."""
        raw = self.get("passThroughArgs")
        if not raw:
            return
        for tok in raw.split():
            if "=" not in tok:
                continue
            key, _, val = tok.partition("=")
            if hasattr(cfg, key):
                cur = getattr(cfg, key)
                typ = type(cur) if cur is not None else str
                if typ is bool:
                    setattr(cfg, key, val.lower() in ("1", "true", "yes"))
                elif typ in (int, float):
                    setattr(cfg, key, typ(float(val)))
                else:
                    setattr(cfg, key, val)

    def _categorical_indexes(self, feature_names: Optional[List[str]]
                             ) -> List[int]:
        """``categoricalSlotIndexes`` plus the indexes of the
        ``categoricalSlotNames`` found in ``feature_names``, sorted."""
        idx = list(self.get("categoricalSlotIndexes") or [])
        names = self.get("categoricalSlotNames") or []
        if names and feature_names:
            idx += [feature_names.index(n) for n in names
                    if n in feature_names]
        return sorted(set(int(i) for i in idx))

    def _apply_missing_params(self, X: np.ndarray) -> np.ndarray:
        """useMissing=False coerces NaN to 0; zeroAsMissing=True maps
        |x| <= 1e-35 to NaN so those rows land in the missing bin."""
        if not self.get("useMissing"):
            return np.nan_to_num(X, nan=0.0)
        if self.get("zeroAsMissing"):
            X = np.asarray(X, np.float32).copy()
            X[np.abs(X) <= 1e-35] = np.nan
        return X

    def _extract_training_arrays(self, df: Table):
        X = self._apply_missing_params(
            feature_matrix(df, self.getFeaturesCol()))
        y = np.asarray(df[self.getLabelCol()], np.float32)
        w = (np.asarray(df[self.get("weightCol")], np.float32)
             if self.get("weightCol") and self.get("weightCol") in df else None)
        init = (np.asarray(df[self.get("initScoreCol")], np.float32)
                if self.get("initScoreCol") and self.get("initScoreCol") in df else None)
        return X, y, w, init

    def _split_validation(self, df: Table):
        """(training rows, validation rows or None) by the
        ``validationIndicatorCol`` flag."""
        vcol = self.get("validationIndicatorCol")
        if vcol and vcol in df:
            mask = np.asarray(df[vcol], bool)
            return df.filter(~mask), df.filter(mask)
        return df, None

    def _train(self, X, y, w, init, cfg, valid=None, **kw) -> Booster:
        """``train_booster`` on the estimator's device, warm-started from
        ``modelString`` and split into ``numBatches`` sequential batches
        (a permutation of the rows from ``seed``; each batch bins with its
        own mapper and warm-starts from the last), the phase spans logged
        as ``trainingMeasures``."""
        from ..core.logging import InstrumentationMeasures

        measures = InstrumentationMeasures()
        dev = self.getDevice()
        bst = (Booster.from_model_string(self.get("modelString"), device=dev)
               if self.get("modelString") else None)
        nb = self.getNumBatches()
        parts = (np.array_split(np.random.default_rng(
            self.getSeed()).permutation(len(y)), nb)
            if nb and nb > 1 else [slice(None)])
        cats = self._categorical_indexes(self.get("slotNames"))
        for part in parts:
            def pick(a, part=part):
                return None if a is None else a[part]

            bst = train_booster(pick(X), pick(y), cfg,
                                sample_weight=pick(w), init_score=pick(init),
                                categorical_features=cats, valid=valid,
                                feature_names=self.get("slotNames"),
                                init_model=bst, fobj=self.get("fobj"),
                                mapper=self._reference_mapper(pick(X)),
                                measures=measures, device=dev, **kw)
        self._log_base("trainingMeasures", measures.report())
        return bst

    def _copy_model_params(self, model) -> None:
        for p in ("featuresCol", "predictionCol", "probabilityCol",
                  "rawPredictionCol", "leafPredictionCol", "featuresShapCol",
                  "thresholds", "predictDisableShapeCheck", "device"):
            if self.hasParam(p) and model.hasParam(p) and self.isSet(p):
                model.set(p, self.get(p))


class _LightGBMModelBase(Model, HasFeaturesCol, HasPredictionCol, _DeviceParam):
    leafPredictionCol = Param("leafPredictionCol", "Output column for leaf indices", str)
    featuresShapCol = Param("featuresShapCol", "Output column for SHAP values", str)
    predictDisableShapeCheck = Param(
        "predictDisableShapeCheck",
        "Truncate/pad prediction features to the trained width instead of "
        "raising on mismatch", bool, False)

    def __init__(self, booster: Optional[Booster] = None, **kwargs):
        super().__init__(**kwargs)
        self.booster = booster

    # --- persistence of the native model string --------------------------
    def _save_extra(self, path: str) -> None:
        if self.booster is not None:
            self.booster.save_native(os.path.join(path, "model.txt"))

    def _load_extra(self, path: str) -> None:
        p = os.path.join(path, "model.txt")
        if os.path.exists(p):
            with open(p) as fh:
                self.booster = Booster.from_model_string(
                    fh.read(), device=self.getDevice())

    def dumpModel(self, num_iteration: int = -1) -> str:
        """JSON model dump (dumpModel)."""
        return self.booster.dump_model(num_iteration)

    def saveNativeModel(self, path: str, overwrite: bool = True) -> None:
        """LightGBMModelMethods.saveNativeModel parity."""
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(path)
        self.booster.save_native(path)

    def getBoosterBestIteration(self) -> int:
        """Best validation iteration (-1 without validation)."""
        return int(self.booster.best_iteration)

    def getBoosterBestScore(self):
        """Best validation metric value (None without validation)."""
        return self.booster.best_score

    def getBoosterNumTotalIterations(self) -> int:
        return self.booster.num_trees // self.booster.models_per_iter

    def getBoosterNumTotalModel(self) -> int:
        return self.booster.num_trees

    def getBoosterNumFeatures(self) -> int:
        return self.booster.mapper.num_features

    def getBoosterNumClasses(self) -> int:
        return self.booster.num_class

    def getNativeModel(self) -> str:
        return self.booster.model_string()

    def getFeatureImportances(self, importance_type: str = "split"):
        return list(self.booster.feature_importances(importance_type))

    def getFeatureShaps(self, X) -> np.ndarray:
        return self.booster.feature_shap(np.asarray(X, np.float32))

    def _predict_matrix(self, df: Table) -> np.ndarray:
        """Feature matrix for prediction, validated against the trained
        width; predictDisableShapeCheck=True truncates / zero-pads instead."""
        X = feature_matrix(df, self.getFeaturesCol())
        nf = self.booster.mapper.num_features
        if X.shape[1] != nf:
            if not self.get("predictDisableShapeCheck"):
                raise ValueError(
                    f"prediction data has {X.shape[1]} features but the "
                    f"model was trained with {nf}; set "
                    "predictDisableShapeCheck=True to truncate/pad")
            if X.shape[1] > nf:
                X = X[:, :nf]
            else:
                X = np.concatenate(
                    [X, np.zeros((X.shape[0], nf - X.shape[1]),
                                 X.dtype)], axis=1)
        return X

    def _maybe_extra_cols(self, out: Table, X) -> Table:
        """The leaf-index and SHAP columns, when their params are set."""
        if self.get("leafPredictionCol"):
            out = out.with_column(
                self.get("leafPredictionCol"),
                self.booster.predict_leaf(X).astype(np.float64))
        if self.get("featuresShapCol"):
            out = out.with_column(self.get("featuresShapCol"),
                                  self.booster.feature_shap(X))
        return out


# ---------------------------------------------------------------------------
# Classifier
# ---------------------------------------------------------------------------

class LightGBMClassifier(Estimator, _LightGBMParams, HasProbabilityCol, HasRawPredictionCol):
    """Binary / multiclass GBDT classifier (reference:
    LightGBMClassifier.scala)."""

    objective = Param("objective", "binary, multiclass or multiclassova", str,
                      "binary")
    isUnbalance = Param("isUnbalance", "Adjust for unbalanced binary labels", bool, False)
    maxNumClasses = Param("maxNumClasses", "Upper bound on auto-detected "
                          "label classes (guards runaway continuous labels)",
                          int, 100)
    scalePosWeight = Param("scalePosWeight", "Positive-class weight multiplier", float, 1.0)
    thresholds = Param("thresholds", "Per-class prediction thresholds", list)

    def _fit(self, df: Table) -> "LightGBMClassificationModel":
        train_df, valid_df = self._split_validation(df)
        X, y, w, init = self._extract_training_arrays(train_df)
        # map arbitrary label values to 0..K-1; the model maps predictions
        # back through classes_
        classes, y_idx = np.unique(y, return_inverse=True)
        num_class = len(classes)
        if num_class < 2:
            raise ValueError(f"need at least 2 label classes, got {classes}")
        if num_class > self.getMaxNumClasses():
            raise ValueError(
                f"detected {num_class} label classes, above maxNumClasses="
                f"{self.getMaxNumClasses()} — a continuous label column was "
                "likely passed to the classifier (raise maxNumClasses if "
                "this cardinality is intended)")
        y = y_idx.astype(np.float32)
        objective = self.getObjective()
        if objective == "binary" and num_class > 2:
            objective = "multiclass"
        cfg = self._base_config(
            objective=objective,
            num_class=(num_class if objective != "binary" else 1))
        if self.getIsUnbalance() and objective == "binary":
            npos = max(float((y > 0).sum()), 1.0)
            nneg = max(float((y <= 0).sum()), 1.0)
            w = (w if w is not None else np.ones_like(y)) * np.where(y > 0, nneg / npos, 1.0)
        elif self.getScalePosWeight() != 1.0 and objective == "binary":
            w = (w if w is not None else np.ones_like(y)) * np.where(
                y > 0, self.getScalePosWeight(), 1.0)

        valid = None
        if valid_df is not None and valid_df.num_rows:
            Xv, yv, _, _ = self._extract_training_arrays(valid_df)
            valid = (Xv, np.searchsorted(classes, yv).astype(np.float32))
        model = LightGBMClassificationModel(
            self._train(X, y, w, init, cfg, valid))
        model.classes_ = classes.astype(np.float64)
        self._copy_model_params(model)
        return model


class LightGBMClassificationModel(_LightGBMModelBase, HasProbabilityCol, HasRawPredictionCol):
    thresholds = Param("thresholds", "Per-class prediction thresholds", list)

    classes_: Optional[np.ndarray] = None   # original label values, index = class id

    def _transform(self, df: Table) -> Table:
        X = self._predict_matrix(df)
        # one traversal: the probabilities are the objective's transform of
        # these raw scores, as predict() computes them
        raw_t = self.booster._raw_score_tensor(X)
        raw = raw_t.cpu().numpy()
        prob = self.booster._objective_for_transform().transform(
            raw_t).cpu().numpy()
        if raw.ndim == 1:
            raw2 = np.stack([-raw, raw], axis=1)
            prob2 = np.stack([1 - prob, prob], axis=1)
        else:
            raw2, prob2 = raw, prob
        out = df.with_column(self.getRawPredictionCol(), raw2)
        out = out.with_column(self.getProbabilityCol(), prob2)
        th = self.get("thresholds")
        scaled = prob2 / np.asarray(th)[None, :] if th else prob2
        pred = np.argmax(scaled, 1)
        if self.classes_ is not None:
            pred = np.asarray(self.classes_)[pred]
        out = out.with_column(self.getPredictionCol(), pred.astype(np.float64))
        return self._maybe_extra_cols(out, X)

    def _save_extra(self, path: str) -> None:
        super()._save_extra(path)
        if self.classes_ is not None:
            np.save(os.path.join(path, "classes.npy"), np.asarray(self.classes_))

    def _load_extra(self, path: str) -> None:
        super()._load_extra(path)
        p = os.path.join(path, "classes.npy")
        if os.path.exists(p):
            self.classes_ = np.load(p)


# ---------------------------------------------------------------------------
# Regressor
# ---------------------------------------------------------------------------

class LightGBMRegressor(Estimator, _LightGBMParams):
    """GBDT regressor (reference: LightGBMRegressor.scala). Objectives:
    regression, regression_l1, huber, fair, poisson, quantile, mape, gamma,
    tweedie, cross_entropy (and their aliases)."""

    objective = Param("objective", "Regression objective", str, "regression")
    alpha = Param("alpha", "Huber/quantile alpha", float, 0.9)
    tweedieVariancePower = Param("tweedieVariancePower", "Tweedie variance power", float, 1.5)

    def _fit(self, df: Table) -> "LightGBMRegressionModel":
        train_df, valid_df = self._split_validation(df)
        X, y, w, init = self._extract_training_arrays(train_df)
        cfg = self._base_config(objective=self.getObjective(),
                                alpha=self.getAlpha(),
                                tweedie_variance_power=self.getTweedieVariancePower())
        valid = None
        if valid_df is not None and valid_df.num_rows:
            Xv, yv, _, _ = self._extract_training_arrays(valid_df)
            valid = (Xv, yv)
        model = LightGBMRegressionModel(self._train(X, y, w, init, cfg, valid))
        self._copy_model_params(model)
        return model


class LightGBMRegressionModel(_LightGBMModelBase):
    def _transform(self, df: Table) -> Table:
        X = self._predict_matrix(df)
        out = df.with_column(self.getPredictionCol(),
                             self.booster.predict(X).astype(np.float64))
        return self._maybe_extra_cols(out, X)


# ---------------------------------------------------------------------------
# Ranker
# ---------------------------------------------------------------------------

class LightGBMRanker(Estimator, _LightGBMParams, HasGroupCol):
    """LambdaRank GBDT (reference: LightGBMRanker.scala). Rows are re-sorted
    group-contiguously before training, the analog of the reference's
    repartitionForGroupColumn; the objective is always lambdarank."""

    objective = Param("objective", "Ranking objective", str, "lambdarank")
    maxPosition = Param("maxPosition", "NDCG truncation for optimization", int, 20)
    labelGain = Param("labelGain", "Relevance gains per label value", list)
    evalAt = Param("evalAt", "NDCG@k eval positions", list, [1, 2, 3, 4, 5])

    def _fit(self, df: Table) -> "LightGBMRankerModel":
        if self.get("modelString") or self.getNumBatches() > 1:
            raise NotImplementedError(
                "LightGBMRanker does not warm-start (modelString) or fit in "
                "batches (numBatches > 1)")
        train_df, valid_df = self._split_validation(df)
        gcol = self.getGroupCol()
        train_df = train_df.sort_by(gcol)      # group-contiguous layout
        X, y, w, init = self._extract_training_arrays(train_df)
        _, sizes = np.unique(np.asarray(train_df[gcol]), return_counts=True)
        cfg = self._base_config(objective="lambdarank",
                                lambdarank_truncation_level=self.getMaxPosition(),
                                eval_at=tuple(self.getEvalAt()),
                                label_gain=tuple(self.get("labelGain") or ()))
        valid = None
        if valid_df is not None and valid_df.num_rows:
            valid_df = valid_df.sort_by(gcol)
            Xv, yv, _, _ = self._extract_training_arrays(valid_df)
            _, sv = np.unique(np.asarray(valid_df[gcol]), return_counts=True)
            valid = (Xv, yv, None, sv)
        model = LightGBMRankerModel(self._train(X, y, w, init, cfg, valid,
                                                group_sizes=sizes))
        self._copy_model_params(model)
        return model


class LightGBMRankerModel(_LightGBMModelBase):
    def _transform(self, df: Table) -> Table:
        X = self._predict_matrix(df)
        out = df.with_column(self.getPredictionCol(),
                             self.booster.predict(X).astype(np.float64))
        return self._maybe_extra_cols(out, X)
