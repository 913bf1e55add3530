"""Boosting driver: the training-iteration loop and the Booster model.

Counterpart of the JAX package's ``gbdt/boosting.py`` for the slice that is
ported: every boosting type (gbdt, goss, dart, rf) with every objective of
``objectives.py`` (binary, multiclass and multiclassova, the regression
family, lambdarank over ``group_sizes``) or a custom ``fobj`` on dense or
scipy sparse (CSR) rows with numeric and categorical features, grown
leaf-wise (the partition row layout) or depthwise
(``growth_policy="depthwise"``, one ``level_histograms`` pass per level),
with bagging (plain and stratified), feature fractions per tree and per
node, monotone constraints, validation sets, early stopping, warm starts
and checkpoint resume.
``train_booster`` is a plain Python loop over iterations: the gradients of
all K classes once, then K trees in class order, each from its class's
gradient row and each adding its leaves to its class's score column (and
to the validation score) before the next; trees are stored
iteration-major (``it * K + c``). These are the semantics of the JAX
package's host loop; its fused ``lax.scan`` runner has no counterpart,
since PyTorch runs eagerly, and gives the same trees and best iteration.

Sampling is the JAX package's, draw for draw: every per-iteration sample
comes from ``core.prng`` (the threefry stream of ``jax.random``) keyed by
``fold_in`` of the config's seeds and the iteration, on the fit's device
(``_sample_rows_impl``, ``_sample_features_impl``, ``_node_key_data``), and
DART's drop decisions from the same host ``numpy`` generator. DART keeps
each tree's training contribution on the device and rebuilds the score
from them after a drop; DART and RF score validation rows from the stacked
per-tree contributions with the current weights.

``Booster`` scores with a prediction window (``num_iteration``,
``start_iteration``), predicts leaf indices, computes TreeSHAP
contributions (``shap.py``) and dumps LightGBM's text and JSON formats.

Distributed (``mesh=``, a ``parallel.make_mesh`` of an initialised
``torch.distributed`` world; every rank calls ``train_booster`` with the
same whole ``X``, ``y`` and config). The JAX package's single-process mesh
mapped onto ranks: the rows are padded to a multiple of the ``data`` axis
as it pads them (the last row repeated, label, weight and valid mask 0),
each rank bins and keeps its contiguous block of them on its device (the
``(FP, N / k)`` bin matrix, the memory that matters) and grows every tree
over its block, with a histogram reduction after each kernel
(``grower``); the O(N) vectors (labels, weights, scores, gradients, the
sampling masks) stay whole on every rank, so every global-row quantity
(bagging and GOSS draws, lambdarank groups, the base score, validation)
comes out as the JAX package's global arrays give it, and each tree's
``node_of_row`` blocks are gathered to update the score. Every rank returns
the same booster, with a model string bitwise the same. ``tree_learner``:
"data" (and "serial", the same on a mesh), "feature" (the owned-feature
reduce-scatter; it falls back to "data" when the padded features do not
divide the axis), "voting" (``voting.py``; it runs only when the features
outnumber ``2 top_k``) and "auto" (the measured router: one timed
all-reduce and, where voting is a candidate, one timed election, cached per
mesh and agreed by the ranks, then ``voting.route_parallelism``; the
decision lands in ``Booster.metadata["routing"]``). Without a mesh every
learner trains the serial trees, as in the JAX package.
``hist_allreduce_dtype`` "f32", "bf16", "int8" picks the histogram wire,
"auto" resolves to "f32" (``core.perfmodel``). With a checkpoint store on a
mesh rank 0 commits the snapshot and every rank waits for it; a snapshot
holds the original rows alone, in global row order, so it resumes on any
mesh or in one process.

Multi-process (``parallel.initialize_distributed``, the JAX package's
multi-controller world): each process passes only its own rows. The bin
mapper comes from a sample gathered in rank order (``ceil(
bin_sample_count / nproc)`` rows drawn by each process), NaN bins and
categorical presence elected over every process's rows, or from rank 0's
explicit ``mapper``; each process's rows are its block of the mesh, ``n``
and the labels and weights become the global ones (gathered), and the fit
is then the mesh fit of every process's rows in rank order. The JAX
package's refusals stand (``fobj``, ``callbacks``, ``init_model``,
``valid``, ``init_score``, ``group_sizes``, dart, the voting and feature
learners), and ``tree_learner="auto"`` takes the static model.

``BoosterConfig`` keeps every field name and default of the JAX config, so a
config carries across unchanged, the grower's engine knobs (``row_layout``,
``partition_impl``, ``use_segmented``) included.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core import prng
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..parallel.collectives import allgather
from ..ops.quantize import (BinMapper, apply_bins, bin_threshold_to_value,
                            compute_bin_mapper)
from .dataset import Dataset, _is_sparse, sparse_bin_mapper
from .grower import (Forest, GrowerConfig, TreeArrays, forest_leaves,
                     forest_max_depth, forest_predict, grow_tree, stack_trees,
                     transpose_bins, tree_leaves_binned, trees_to_host)
from .objectives import (HIGHER_IS_BETTER, METRICS, Objective, get_objective,
                         lambdarank_objective, make_grouped, map_at_k,
                         metric_kwargs, ndcg_at_k, regression_objective)

MULTICLASS = ("multiclass", "softmax", "multiclassova")


@dataclasses.dataclass
class BoosterConfig:
    """Training configuration — field names and defaults of the JAX package's
    ``BoosterConfig`` (LightGBM's canonical param names). Fields of features
    the slice does not port are kept so configs carry across; ``train_booster``
    rejects any of them set away from the ported behaviour."""

    objective: str = "regression"
    boosting_type: str = "gbdt"          # gbdt | rf | dart | goss
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_bin: int = 255
    max_depth: int = -1
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    top_rate: float = 0.2                # goss
    other_rate: float = 0.1              # goss
    drop_rate: float = 0.1               # dart
    max_drop: int = 50
    skip_drop: float = 0.5
    uniform_drop: bool = False
    num_class: int = 1
    sigmoid: float = 1.0
    alpha: float = 0.9                   # huber / quantile
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    max_delta_step: float = 0.0
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    xgboost_dart_mode: bool = False
    monotone_constraints: Optional[Sequence[int]] = None
    early_stopping_round: int = 0
    metric: Optional[str] = None
    seed: int = 0
    boost_from_average: bool = True
    bin_sample_count: int = 200_000
    min_data_in_bin: int = 3              # merge under-filled bins (minDataPerBin)
    max_bin_by_feature: Optional[Sequence[int]] = None
    cat_l2: float = 10.0                  # categorical split L2 (catl2)
    drop_seed: int = 0
    feature_fraction_seed: int = 0
    extra_seed: int = 0
    start_iteration: int = 0              # prediction start (predict window)
    # distributed tree learner; without a mesh every value trains the
    # serial trees
    tree_learner: str = "auto"
    top_k: int = 20
    # engine knobs of the JAX grower (gbdt/grower.py): the stable
    # partition's primitive, the leaf-wise row layout, the segmented range
    # kernel, the growth policy
    partition_impl: str = "sort"
    row_layout: str = "partition"
    use_segmented: Optional[bool] = None
    growth_policy: str = "leafwise"
    hist_allreduce_dtype: str = "f32"
    lambdarank_truncation_level: int = 30
    max_position: int = 30
    label_gain: tuple = ()
    bagging_seed: int = 3
    improvement_tolerance: float = 0.0
    data_random_seed: object = None
    # features' missing code becomes zero (zeroAsMissing): the estimator
    # layer maps 0 -> NaN before binning and traversal routes |x|<=1e-35
    # (and coerced NaN) to the default side
    zero_as_missing: bool = False
    eval_at: tuple = ()

    def __post_init__(self):
        for field, allowed in (
                ("partition_impl", ("sort", "sort32", "scan", "scatter")),
                ("row_layout", ("partition", "masked", "gather")),
                ("growth_policy", ("leafwise", "depthwise")),
                ("hist_allreduce_dtype", ("auto", "f32", "bf16", "int8")),
                ("tree_learner", ("auto", "serial", "data", "voting",
                                  "feature"))):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(
                    f"BoosterConfig.{field}={v!r} is not one of {allowed}")

    def unported(self) -> List[str]:
        """``name=value`` of every setting the port does not implement."""
        out = []

        def check(name, ok):
            if not ok:
                out.append(f"{name}={getattr(self, name)!r}")

        check("boosting_type",
              self.boosting_type in ("gbdt", "goss", "dart", "rf"))
        return out

    def grower(self, has_categorical: bool = False,
               feature_shards: int = 1) -> GrowerConfig:
        # rf trees are averaged, not shrunk
        lr = 1.0 if self.boosting_type == "rf" else self.learning_rate
        feature_mode = self.tree_learner == "feature" and feature_shards > 1
        return GrowerConfig(
            hist_reduce="scatter" if feature_mode else "allreduce",
            feature_shards=feature_shards if feature_mode else 1,
            hist_allreduce_dtype=self.hist_allreduce_dtype,
            has_categorical=has_categorical,
            cat_smooth=self.cat_smooth,
            cat_l2=self.cat_l2,
            max_cat_threshold=self.max_cat_threshold,
            max_cat_to_onehot=self.max_cat_to_onehot,
            min_data_per_group=self.min_data_per_group,
            num_leaves=self.num_leaves,
            num_bins=self.max_bin,
            max_depth=self.max_depth,
            lambda_l1=self.lambda_l1,
            lambda_l2=self.lambda_l2,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            min_gain_to_split=self.min_gain_to_split,
            learning_rate=lr,
            max_delta_step=self.max_delta_step,
            growth_policy=self.growth_policy,
            feature_fraction_bynode=self.feature_fraction_bynode,
            partition_impl=self.partition_impl,
            row_layout=self.row_layout,
            use_segmented=self.use_segmented,
        )


class Booster:
    """A trained forest + binning metadata (the LightGBMBooster analog):
    scoring, model-string save/load, feature importances. Scoring runs on
    ``device``."""

    def __init__(self, mapper: BinMapper, config: BoosterConfig,
                 trees: List[TreeArrays], tree_weights: List[float],
                 base_score: np.ndarray, feature_names: Optional[List[str]] = None,
                 best_iteration: int = -1,
                 thresholds: Optional[List[np.ndarray]] = None,
                 missing_types: Optional[List[np.ndarray]] = None,
                 best_score: Optional[float] = None,
                 metadata: Optional[dict] = None,
                 device=DEFAULT_DEVICE):
        self.mapper = mapper
        self.metadata: dict = dict(metadata) if metadata else {}
        self.config = config
        self.trees = trees
        self.tree_weights = list(tree_weights)
        self.base_score = np.atleast_1d(np.asarray(base_score, np.float64))
        self.feature_names = feature_names or [f"Column_{i}" for i in range(mapper.num_features)]
        self.best_iteration = best_iteration
        self.best_score = best_score
        # real-valued thresholds per tree; None → resolve from the bin mapper.
        # Loaded native models carry raw thresholds directly (no mapper).
        self.thresholds = thresholds
        # per-split LightGBM missing-type codes (0 none / 1 zero / 2 nan)
        self.missing_types = missing_types
        self.device = resolve_device(device)
        self._forest_cache: Optional[Forest] = None
        self._depth_cache: Optional[int] = None
        # predict(batch_size=...)'s bucketed serving callables, one per
        # batch size
        self._serving_cache: dict = {}

    # --- structure ------------------------------------------------------
    @property
    def num_class(self) -> int:
        return max(self.config.num_class, 1)

    @property
    def models_per_iter(self) -> int:
        return self.num_class if self.config.objective in MULTICLASS else 1

    @property
    def num_trees(self) -> int:
        return len(self.trees)

    @property
    def average_output(self) -> bool:
        return self.config.boosting_type == "rf"

    @property
    def trees_per_class(self) -> int:
        return max(len(self.trees) // self.models_per_iter, 1)

    def _thresholds(self, index: int) -> np.ndarray:
        if self.thresholds is not None:
            t = (self.thresholds[index]
                 if index < len(self.thresholds) else None)
            if t is not None:
                return np.asarray(t, np.float32)
        tree = self.trees[index]
        sf = np.asarray(tree.split_feature)
        sb = np.asarray(tree.split_bin)
        vals = np.array([bin_threshold_to_value(self.mapper, int(f), int(b))
                         for f, b in zip(sf, sb)], np.float64)
        # top-bin sentinel is 1e308 (finite in f64 model strings); map it to an
        # INTENTIONAL f32 inf so +inf feature values still go left
        f32max = np.float64(np.finfo(np.float32).max)
        return np.where(vals >= f32max, np.inf,
                        np.clip(vals, -f32max, f32max)).astype(np.float32)

    def _missing_types(self, index: int) -> np.ndarray:
        """(L-1,) missing-type codes for one tree: parsed values for loaded
        models, else nan (2) for features with a NaN bin AND for categorical
        splits / 0 otherwise — the codes the model-string writer emits."""
        if self.missing_types is not None:
            m = (self.missing_types[index]
                 if index < len(self.missing_types) else None)
            if m is not None:
                return np.asarray(m, np.int32)
        tree = self.trees[index]
        sf = np.asarray(tree.split_feature).astype(np.int64)
        stype = np.asarray(tree.split_type)
        has_nan = np.asarray(self.mapper.nan_mask)
        sf_safe = np.clip(sf, 0, len(has_nan) - 1)
        nan_code = 1 if getattr(self.config, "zero_as_missing", False) else 2
        return np.where(stype[: len(sf)] == 1, 2,
                        np.where(has_nan[sf_safe], nan_code,
                                 0)).astype(np.int32)

    def unweighted(self) -> "Booster":
        """Copy with unit tree weights and zero base — the raw per-tree
        contributions. Thresholds and missing codes ride along (a loaded
        model's mapper has no boundaries)."""
        return Booster(self.mapper, self.config, self.trees,
                       [1.0] * len(self.trees),
                       np.zeros_like(self.base_score),
                       thresholds=self.thresholds,
                       missing_types=self.missing_types, device=self.device)

    def forest(self) -> Forest:
        if self._forest_cache is None or self._forest_cache.num_trees != len(self.trees):
            weights = np.asarray(self.tree_weights, np.float32)
            if self.average_output:
                weights = weights / self.trees_per_class
            weighted = [t._replace(leaf_value=np.asarray(t.leaf_value, np.float32) * w)
                        for t, w in zip(self.trees, weights)]
            self._forest_cache = stack_trees(
                weighted, [self._thresholds(i) for i in range(len(self.trees))],
                [self._missing_types(i) for i in range(len(self.trees))],
                self.device)
            self._depth_cache = forest_max_depth(self.trees)
        return self._forest_cache

    # --- inference ------------------------------------------------------
    def _window_start(self, start_iteration: Optional[int]) -> int:
        if start_iteration is None:
            start_iteration = getattr(self.config, "start_iteration", 0)
        return max(int(start_iteration), 0)

    def _raw_score_tensor(self, X, num_iteration: int = -1,
                          start_iteration: Optional[int] = None,
                          binned: bool = False) -> torch.Tensor:
        k = self.models_per_iter
        nan_bins = None
        if binned:
            X = torch.as_tensor(np.asarray(X)).to(self.device, torch.int64)
            nan_bins = torch.as_tensor(
                np.asarray(self.mapper.nan_bins, np.int64), device=self.device)
        else:
            X = torch.as_tensor(_densify(X)).to(self.device)
        if X.dim() != 2:
            raise ValueError(f"X must be (N, F), got shape {tuple(X.shape)}")
        base = torch.as_tensor(self.base_score[:k].astype(np.float32),
                               device=self.device)
        forest = self.forest() if self.trees else None
        return self._raw_of(forest, X, base,
                            self._window_start(start_iteration),
                            num_iteration, nan_bins)

    def _raw_of(self, forest: Optional[Forest], X: torch.Tensor,
                base: torch.Tensor, start: int, num_iteration: int = -1,
                nan_bins: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N,) or (N, K) raw margin of the device rows ``X`` from an
        already-stacked ``forest`` (None: no trees) and base tensor: the
        window's trees of each class summed in iteration order, an RF
        average rescaled to the window, then the base. No host round trip,
        so the serving runner can capture it in a CUDA graph."""
        k = self.models_per_iter
        if forest is None:
            out = torch.zeros((X.shape[0], k), dtype=torch.float32,
                              device=X.device)
        else:
            out = forest_predict(forest, X, self._depth_cache, num_class=k,
                                 start_iteration=start,
                                 num_iteration=num_iteration,
                                 nan_bins=nan_bins)
            total = forest.num_trees // k
            t0 = min(start, total)
            t1 = total if not num_iteration or num_iteration <= 0 \
                else min(total, t0 + int(num_iteration))
            if self.average_output and t1 - t0 != total:
                # rf leaves were pre-divided by the full tree count; rescale
                # so the windowed average stays an average of its trees
                out = out * (total / max(t1 - t0, 1))
        out = out + base
        return out[:, 0] if k == 1 else out

    def raw_score(self, X, binned: bool = False, num_iteration: int = -1,
                  start_iteration: Optional[int] = None) -> np.ndarray:
        """(N,) raw margin, (N, K) for K classes, of dense or scipy sparse
        rows, or of rows already binned with the booster's mapper
        (``binned=True``). ``num_iteration`` > 0 scores with only that many
        boosting rounds; ``start_iteration`` (default: the config's
        prediction window) skips leading rounds. Warm starts pass
        ``start_iteration=0``: the window is a prediction feature and must
        not leak into a continued fit."""
        return self._raw_score_tensor(X, num_iteration, start_iteration,
                                      binned).cpu().numpy()

    def predict(self, X, binned: bool = False, num_iteration: int = -1,
                batch_size: Optional[int] = None) -> np.ndarray:
        """Probability / response-space prediction.

        ``batch_size`` routes batch predict through the bucketed serving
        runner (``core/inference.py``): rows go ``batch_size`` at a time
        with a bucket-padded tail, each chunk one replay of a captured CUDA
        graph on the card (one eager call per chunk on the CPU), with the
        unbatched values. The runner is cached per ``batch_size`` (each
        ``serving_fn`` call builds a runner of its own). It serves the full
        raw-value model, so ``binned`` rows and an iteration window raise
        ``ValueError`` with it."""
        if batch_size is not None:
            if binned or (num_iteration and num_iteration > 0):
                raise ValueError(
                    "predict(batch_size=...) serves the full raw-value "
                    "model; binned inputs or an iteration window need the "
                    "unbatched path")
            if int(batch_size) < 1:
                raise ValueError(
                    f"batch_size must be >= 1, got {batch_size}")
            serve = self._serving_cache.get(int(batch_size))
            if serve is None:
                serve = self.serving_fn(max_batch_size=int(batch_size))
                self._serving_cache[int(batch_size)] = serve
            return serve(X)
        obj = self._objective_for_transform()
        return obj.transform(self._raw_score_tensor(
            X, num_iteration, binned=binned)).cpu().numpy()

    def serving_fn(self, max_batch_size: int = 64, bucketed: bool = True):
        """Callable ``X (N, F) -> prediction`` for low-latency serving:
        forest traversal with the base score, the config's
        ``start_iteration`` window, the RF rescale and the objective's
        output transform. The forest, the base tensor and the depth are
        built on the booster's device once, here, so a call moves nothing
        from the host but its rows.

        By default the callable runs through a shape-bucketed runner
        (``core/inference.py``): batches pad up to a geometric ladder of
        bucket sizes, each bucket one captured CUDA graph on the card,
        with padded rows sliced off the result. The returned callable takes
        host rows, returns numpy, and carries ``.runner`` (per-bucket
        capture/hit counters) and ``.warmup()`` (capture every bucket;
        ``ServingServer.start()`` calls it before accepting traffic).
        ``bucketed=False`` returns the plain function on device tensors
        (array-likes are moved to the device), returning a tensor, for
        callers that manage their own shapes."""
        obj = self._objective_for_transform()
        k = self.models_per_iter
        base = torch.as_tensor(self.base_score[:k].astype(np.float32),
                               device=self.device)
        forest = self.forest() if self.trees else None
        start = self._window_start(None)

        def fn(X: torch.Tensor) -> torch.Tensor:
            return obj.transform(self._raw_of(forest, X, base, start))

        if not bucketed:
            def plain(X) -> torch.Tensor:
                if not isinstance(X, torch.Tensor):
                    X = _densify(X)
                return fn(torch.as_tensor(X, dtype=torch.float32,
                                          device=self.device))

            return plain

        from ..core.inference import BucketedRunner

        runner = BucketedRunner(fn, max_batch_size=max_batch_size,
                                name="gbdt.serving_fn", device=self.device)
        num_features = self.mapper.num_features

        def serve(X) -> np.ndarray:
            return runner(_densify(X))

        def warmup(dtype=np.float32) -> dict:
            return runner.warmup(np.zeros((1, num_features), dtype))

        serve.runner = runner
        serve.warmup = warmup
        return serve

    def to_onnx(self, input_name: str = "input", num_iteration: int = -1):
        """The booster as an ONNX TreeEnsemble model (``onnx.protoio.Model``;
        ``.encode()`` gives its bytes), the JAX package's export: serve it
        through ``onnx.ONNXModel``."""
        from ..onnx.treeensemble import booster_to_onnx

        return booster_to_onnx(self, input_name, num_iteration)

    def predict_leaf(self, X) -> np.ndarray:
        """(N, T) int32 leaf index of every row in every tree after the
        config's ``start_iteration`` window (predictLeaf), trees in the
        order ``it * K + c``."""
        X = torch.as_tensor(_densify(X)).to(self.device)
        start = self._window_start(None) * self.models_per_iter
        if not self.trees:
            return np.zeros((X.shape[0], 0), np.int32)
        return forest_leaves(self.forest(), X, self._depth_cache,
                             start_tree=start).cpu().numpy()

    def feature_shap(self, X) -> np.ndarray:
        """TreeSHAP contributions, (N, F+1) or (N, K*(F+1)) (host numpy,
        ``shap.py``)."""
        from .shap import forest_shap

        return forest_shap(self, _densify(X))

    def feature_importances(self, importance_type: str = "split") -> np.ndarray:
        """split count or total gain per feature."""
        imp = np.zeros(self.mapper.num_features)
        for t in self.trees:
            ns = int(t.num_splits)
            sf = np.asarray(t.split_feature)[:ns]
            if importance_type == "gain":
                np.add.at(imp, sf, np.asarray(t.split_gain)[:ns])
            else:
                np.add.at(imp, sf, 1.0)
        return imp

    def _objective_for_transform(self) -> Objective:
        cfg = self.config
        if cfg.objective == "lambdarank":
            return regression_objective()
        return _objective(cfg, self.num_class)

    # --- persistence ----------------------------------------------------
    def dump_model(self, num_iteration: int = -1) -> str:
        """LightGBM-format JSON dump (dumpModel)."""
        from .model_io import booster_dump_json

        return booster_dump_json(self, num_iteration)

    def model_string(self) -> str:
        from .model_io import booster_to_string
        return booster_to_string(self)

    @staticmethod
    def from_model_string(s: str, device=DEFAULT_DEVICE) -> "Booster":
        from .model_io import booster_from_string
        return booster_from_string(s, device=device)

    def save_native(self, path: str) -> None:
        """saveNativeModel parity."""
        with open(path, "w") as f:
            f.write(self.model_string())


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _densify(X) -> np.ndarray:
    """Dense float32 rows of a scipy sparse matrix or anything array-like
    (scoring and validation take CSR as training does)."""
    if _is_sparse(X):
        return np.asarray(X.tocsr().todense(), np.float32)
    return np.asarray(X, np.float32)


def _objective(cfg: BoosterConfig, num_class: int) -> Objective:
    """The config's (non-ranking) objective with its parameters."""
    return get_objective(cfg.objective, num_class=num_class,
                         sigmoid=cfg.sigmoid, alpha=cfg.alpha,
                         fair_c=cfg.fair_c,
                         poisson_max_delta_step=cfg.poisson_max_delta_step,
                         tweedie_variance_power=cfg.tweedie_variance_power)


def _ranking_objective(cfg: BoosterConfig, y: np.ndarray,
                       group_sizes) -> Objective:
    """lambdarank over the group-contiguous rows of ``group_sizes``; a label
    beyond the ``label_gain`` table is refused, as LightGBM does."""
    if group_sizes is None:
        raise ValueError("lambdarank requires group_sizes")
    if cfg.label_gain:
        max_label = int(np.max(y)) if len(y) else 0
        if max_label >= len(cfg.label_gain):
            raise ValueError(
                f"label {max_label} needs a label_gain table of at "
                f"least {max_label + 1} entries, got "
                f"{len(cfg.label_gain)}")
    return lambdarank_objective(make_grouped(y, group_sizes), cfg.sigmoid,
                                cfg.lambdarank_truncation_level,
                                cfg.label_gain)


def _grow_one(binned, bT, g, h, in_bag, feature_active, grower_cfg,
              cfg: BoosterConfig, block, mesh, voting: bool, **kw):
    """One tree from the (n,) gradient rows ``g``/``h`` of one class:
    (TreeArrays, the leaf of every row the grower read). On a mesh the
    grower reads this rank's ``block`` of the rows (``binned``/``bT`` hold
    only it); with ``voting`` the tree grows on the columns the ranks elect
    (``voting.voting_select``) and its split features are mapped back."""
    if block is not None:
        g, h, bag = g[block], h[block], in_bag[block]
    else:
        bag = in_bag
    if voting:
        from .voting import remap_tree_features, voting_select

        sel = voting_select(binned, g * bag, h * bag, bag, mesh, cfg.top_k,
                            cfg.max_bin, cfg.lambda_l2,
                            max(cfg.min_data_in_leaf, 1),
                            feature_active=feature_active)
        sel_d = torch.as_tensor(sel, device=binned.device)
        pick = {name: np.asarray(kw[name])[sel]
                for name in ("nan_bins", "monotone", "is_categorical",
                             "cat_nbins")}
        tree, node = grow_tree(binned[:, sel_d], g, h, bag,
                               feature_active[sel_d], grower_cfg,
                               stats=kw["stats"], node_key=kw["node_key"],
                               mesh=mesh, **pick)
        tree = remap_tree_features(tree, sel)
    else:
        tree, node = grow_tree(binned, g, h, bag, feature_active, grower_cfg,
                               bT0=bT, mesh=mesh, **kw)
    return tree, node


def _perfmodel_route(cfg, n_rows, nfeat, n_workers, choice, info,
                     feature_ok) -> str:
    """The learned-model layer over ``route_parallelism``'s choice: each
    arm's analytic prediction as its prior; with no recorded rows to trust
    (``core.perfmodel``) the cost model's choice stands. The provenance
    lands in ``info["perfmodel"]``."""
    from ..core import perfmodel

    feats = perfmodel.featurize(
        wire_dtype=cfg.hist_allreduce_dtype, rows=n_rows, nfeat=nfeat,
        workers=n_workers, max_bin=cfg.max_bin, top_k=cfg.top_k,
        num_leaves=cfg.num_leaves)
    pred = info.get("predicted_s_per_tree") or {}
    arms = ["data", "voting"] + (["feature"] if feature_ok else [])
    dec = perfmodel.choose_analytic(
        [perfmodel.Candidate("gbdt_tree_learner", arm, feats,
                             analytic_s=pred.get(arm), config=arm)
         for arm in arms], fallback_arm=choice)
    info["perfmodel"] = dec.provenance()
    return choice


def _auto_route(cfg: BoosterConfig, mesh, binned, nfeat: int, n_rows: int,
                has_categorical: bool, multiproc: bool = False):
    """``tree_learner="auto"`` → ``(learner, info)``. Without a mesh (or
    on one rank) the static rule; on a mesh the measured router: the link
    probe and, when voting is a candidate (F > 2k), a timed election on
    this rank's block ``binned``, both cached per mesh (``core.tuned``) and
    agreed by the ranks (the MAX of their seconds), so every rank takes the
    same decision; then ``voting.route_parallelism``. ``info`` becomes
    ``Booster.metadata["routing"]``."""
    from .voting import recommend_tree_learner, route_parallelism

    if mesh is None:
        return "data", {"tree_learner": "data", "router": "static",
                        "reason": "no mesh: serial == data-parallel-of-1"}
    from ..core import tuned
    from ..ops.hist_kernel import features_padded
    from ..parallel.collectives import probe_link_bandwidth

    n_workers = int(mesh.shape.get("data", 1))
    if multiproc or n_workers <= 1:
        from ..parallel.mesh import process_count

        # multi-process: the static model, no probes (the JAX package's
        # choice: a timed collective would need the processes in lockstep)
        choice = recommend_tree_learner(
            nfeat, cfg.max_bin, cfg.top_k, cfg.num_leaves,
            n_hosts=process_count(), rows_per_host=n_rows,
            dtype_bytes=(8 / 3 if cfg.hist_allreduce_dtype == "bf16" else 4))
        if choice == "voting" and multiproc:
            import warnings

            warnings.warn(
                "tree_learner='auto': the collective cost model prefers "
                "voting-parallel at this shape, but multi-process training "
                "does not support the voting learner yet — falling back to "
                "data-parallel. Set tree_learner='voting' on a "
                "single-process mesh to use it.")
            choice = "data"
        reason = ("multi-process: static model (no probes)" if multiproc
                  else "single worker")
        return choice, {"tree_learner": choice, "router": "static",
                        "reason": reason}
    fp = tuned.mesh_fingerprint(mesh)
    link = tuned.measured_or(("link_bytes_per_s", fp),
                             lambda: probe_link_bandwidth(mesh))
    sel_s, sel_frac = None, 1.0
    if nfeat > 2 * cfg.top_k:
        from .voting import time_selection

        sel_s, sel_frac = tuned.measured_or(
            ("selection_s_per_tree", fp, int(n_rows), nfeat, cfg.max_bin,
             cfg.top_k),
            lambda: time_selection(binned, mesh, cfg.top_k, cfg.max_bin,
                                   lambda_l2=cfg.lambda_l2,
                                   min_data=max(cfg.min_data_in_leaf, 1)))
    feature_ok = (not has_categorical and cfg.growth_policy == "leafwise"
                  and cfg.row_layout == "partition"
                  and features_padded(nfeat) % n_workers == 0)
    choice, info = route_parallelism(
        nfeat, cfg.max_bin, cfg.top_k, cfg.num_leaves, n_workers=n_workers,
        rows_per_worker=max(n_rows // n_workers, 1), link_bytes_per_s=link,
        selection_s_per_tree=sel_s, selection_fraction_of_rows=sel_frac,
        wire_dtype=cfg.hist_allreduce_dtype, feature_parallel_ok=feature_ok)
    info["router"] = "measured"
    return _perfmodel_route(cfg, n_rows, nfeat, n_workers, choice, info,
                            feature_ok), info


def _reject_unported(config: BoosterConfig, **args) -> None:
    """Raise naming every argument set away from its default and every
    config setting the port does not implement."""
    bad = [k for k, v in args.items()
           if v is not None and v is not False
           and not (isinstance(v, (list, tuple)) and not v)]
    bad += config.unported()
    if bad:
        raise NotImplementedError(
            "not ported to the PyTorch package yet: " + ", ".join(bad))


def _is_rank_metric(name: str) -> bool:
    """ndcg/ndcg@k/map/map@k (not mape)."""
    return name.split("@")[0] in ("ndcg", "map")


def _default_metric(objective: str) -> str:
    return {
        "binary": "auc",
        "multiclass": "multi_logloss",
        "softmax": "multi_logloss",
        "multiclassova": "multi_logloss",
        "regression_l1": "mae",
        "lambdarank": "ndcg@5",
        # exp-family / robust objectives early-stop on their own loss
        "poisson": "poisson",
        "gamma": "gamma",
        "tweedie": "tweedie",
        "quantile": "quantile",
        "huber": "huber",
        "fair": "fair",
        "mape": "mape",
        "cross_entropy": "cross_entropy",
        "xentropy": "cross_entropy",
    }.get(objective, "rmse")


def _metric_name(cfg: BoosterConfig) -> str:
    """The validation metric: the config's, else the objective's default;
    ndcg/map without a position take ``eval_at[0]`` (else
    ``max_position``), the position early stopping tracks."""
    name = cfg.metric or _default_metric(cfg.objective)
    if name in ("ndcg", "map") or (cfg.metric is None
                                   and name.startswith("ndcg")):
        first_at = cfg.eval_at[0] if cfg.eval_at else cfg.max_position
        name = f"{name.split('@')[0]}@{int(first_at)}"
    if not _is_rank_metric(name) and name not in METRICS:
        raise ValueError(f"unknown metric {name!r}; one of "
                         f"{sorted(METRICS) + ['ndcg@k', 'map@k']}")
    return name


def _eval_metric(name, yv, pred_v, raw_v, gidx_v, cfg=None, wv=None):
    """One validation metric value (a float32 scalar tensor); ``gidx_v``
    is the ranking group index of the validation rows."""
    if _is_rank_metric(name):
        at = int(name.split("@")[1]) if "@" in name else 5
        if name.startswith("map"):
            return map_at_k(yv, raw_v[:, 0], gidx_v, at)
        return ndcg_at_k(yv, raw_v[:, 0], gidx_v, at,
                         cfg.label_gain if cfg is not None else ())
    return METRICS[name](yv, pred_v, weight=wv, **metric_kwargs(cfg))


def _train_fingerprint(cfg, n, nfeat, y, n_init_trees) -> str:
    """Identity of a training run for resume: config, data shape, label
    digest and warm-start length. A snapshot whose fingerprint differs
    belongs to another run and is not resumed from."""
    import hashlib
    import zlib

    h = hashlib.sha256()
    h.update(repr(sorted(dataclasses.asdict(cfg).items())).encode())
    h.update(repr((int(n), int(nfeat), int(n_init_trees),
                   zlib.crc32(np.ascontiguousarray(
                       np.asarray(y, np.float32)).tobytes()))).encode())
    return h.hexdigest()


def _ckpt_save_gbdt(store, iteration, payload, fingerprint, measures):
    import pickle

    with measures.span("checkpointSave"):
        store.save(int(iteration),
                   {"state.pkl": pickle.dumps(payload, protocol=4)},
                   meta={"kind": "gbdt", "path": "host",
                         "fingerprint": fingerprint})


def _ckpt_load_gbdt(store, fingerprint):
    """Newest verified snapshot of this run, or None (fresh start)."""
    import pickle

    from ..core.logging import record_failure

    ckpt = store.load_latest()
    if ckpt is None:
        return None
    if (ckpt.meta.get("kind") != "gbdt" or ckpt.meta.get("path") != "host"
            or ckpt.meta.get("fingerprint") != fingerprint):
        record_failure("checkpoint.fingerprint_mismatch", base=ckpt.base,
                       ckpt_kind=ckpt.meta.get("kind"))
        return None
    return pickle.loads(ckpt.artifacts["state.pkl"])


def _scores_of(booster: Booster, X, k: int, dev) -> torch.Tensor:
    """(n, k) float32 raw score of a warm-start model on ``dev``, every
    iteration counted (no prediction window)."""
    raw = booster.raw_score(X, start_iteration=0)
    return torch.as_tensor(np.asarray(raw, np.float32).reshape(
        len(raw), k)).to(dev)


def _custom_grad_hess(fobj, score, yj, wj, n: int, k: int):
    """Call a custom objective and check what it returns."""
    out = fobj(score[:, 0] if k == 1 else score, yj, wj)
    if not (isinstance(out, (tuple, list)) and len(out) == 2):
        raise ValueError("fobj must return a (grad, hess) pair")
    res = []
    for name, v in zip(("grad", "hess"), out):
        v = torch.as_tensor(v)
        if v.numel() != n * k:
            raise ValueError(
                f"fobj returned {name} of shape {tuple(v.shape)}; expected "
                f"{n * k} values ({(n,) if k == 1 else (n, k)})")
        res.append(v.to(device=score.device, dtype=torch.float32))
    return res


# ---------------------------------------------------------------------------
# Per-iteration sampling (on the fit's device, from the threefry stream)
# ---------------------------------------------------------------------------

def _check_sampling_config(cfg: BoosterConfig) -> None:
    """The JAX package's refusals of degenerate sampling configs."""
    if ((cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0)
            and cfg.objective not in ("binary",)):
        raise ValueError("pos_bagging_fraction / neg_bagging_fraction require "
                         f"objective='binary' (got {cfg.objective!r})")
    if cfg.boosting_type == "rf" and not (
            cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0
            or cfg.feature_fraction < 1.0):
        raise ValueError("boosting_type='rf' requires bagging (bagging_freq > "
                         "0 and bagging_fraction < 1) and/or "
                         "feature_fraction < 1")


def _f32(x: float, dev) -> torch.Tensor:
    """A Python float as a float32 scalar tensor: the JAX package compares
    and multiplies float32 arrays with weakly typed Python floats, which
    round to float32 first."""
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _sample_rows_impl(cfg: BoosterConfig, n: int, key0, it: int, g, h,
                      in_bag_cur, yj=None, valid_mask=None):
    """(in_bag, g, h, in_bag_cur) of iteration ``it``; ``g``/``h`` are the
    (K, n) gradient rows, ``in_bag_cur`` the bag carried between bagging
    rounds. GOSS keeps the ``int(top_rate n)`` rows of largest sum over
    classes of |g| (a stable order) and draws the rest with probability
    ``other_rate n / (n - top_n)``, their g and h amplified by
    ``(1 - top_rate) / other_rate``; bagging draws a fresh bag (per label
    when stratified) every ``bagging_freq`` iterations and carries it
    between. ``valid_mask`` (n,) zeroes the padding rows of a mesh out of
    every draw (None: no padding)."""
    dev = g.device
    stratified = (cfg.pos_bagging_fraction < 1.0
                  or cfg.neg_bagging_fraction < 1.0)
    do_bag = ((cfg.boosting_type == "rf" or cfg.bagging_freq > 0)
              and (cfg.bagging_fraction < 1.0 or stratified))
    if cfg.boosting_type == "goss":
        gnorm = g[0].abs()
        for c in range(1, g.shape[0]):
            gnorm = gnorm + g[c].abs()
        top_n = int(cfg.top_rate * n)
        rand_n = int(cfg.other_rate * n)
        amp = (1.0 - cfg.top_rate) / max(cfg.other_rate, 1e-12)
        order = torch.argsort(-gnorm, stable=True)
        ranks = torch.empty_like(order)
        ranks[order] = torch.arange(n, device=dev)
        kg = prng.fold_in(key0, cfg.extra_seed) if cfg.extra_seed else key0
        u = prng.uniform(prng.fold_in(kg, it), n, dev)
        pick = (ranks >= top_n) & (u < _f32(rand_n / max(n - top_n, 1), dev))
        wmask = torch.where(ranks < top_n, _f32(1.0, dev),
                            torch.where(pick, _f32(amp, dev),
                                        _f32(0.0, dev)))
        if valid_mask is not None:
            wmask = wmask * valid_mask
        return ((wmask > 0).to(torch.float32), g * wmask[None],
                h * wmask[None], in_bag_cur)
    if do_bag:
        if it % max(cfg.bagging_freq, 1):
            return in_bag_cur, g, h, in_bag_cur
        kb = (prng.fold_in(key0, cfg.bagging_seed) if cfg.bagging_seed != 3
              else key0)
        u = prng.uniform(prng.fold_in(kb, 20_000_000 + it), n, dev)
        if stratified and yj is not None:
            frac = torch.where(yj > 0, _f32(cfg.pos_bagging_fraction, dev),
                               _f32(cfg.neg_bagging_fraction, dev))
        else:
            frac = _f32(cfg.bagging_fraction, dev)
        bag = (u < frac).to(torch.float32)
        if valid_mask is not None:
            bag = bag * valid_mask
        return bag, g, h, bag
    return in_bag_cur, g, h, in_bag_cur


def _sample_features_impl(cfg: BoosterConfig, nfeat: int, key0, it: int,
                          device="cpu") -> torch.Tensor:
    """(F,) bool tree mask on ``device``: the first
    ``ceil(feature_fraction F)`` of a permutation drawn for iteration
    ``it``."""
    mask = torch.zeros(nfeat, dtype=torch.bool, device=device)
    if cfg.feature_fraction >= 1.0:
        return mask.fill_(True)
    nf_keep = max(1, int(math.ceil(cfg.feature_fraction * nfeat)))
    kf = (prng.fold_in(key0, cfg.feature_fraction_seed)
          if cfg.feature_fraction_seed else key0)
    perm = prng.permutation(prng.fold_in(kf, 10_000_000 + it), nfeat,
                            device)
    mask[perm[:nf_keep]] = True
    return mask


def _node_key_data(key0, it: int, cls: int):
    """The key of tree (``it``, ``cls``) for ``feature_fraction_bynode``."""
    return prng.fold_in(prng.fold_in(key0, 30_000_000 + cls), it)


def _dart_drops(cfg: BoosterConfig, rng, it: int,
                tree_weights: List[float]) -> np.ndarray:
    """Indices of the trees DART drops at iteration ``it`` (host numpy
    draws: ``rng``, or ``default_rng([drop_seed, it])``): skipped with
    probability ``skip_drop``, else each tree with probability
    ``drop_rate`` (uniform) or ``drop_rate`` scaled by its weight over the
    mean weight (weighted), the first ``max_drop`` kept."""
    nt = len(tree_weights)
    drop_rng = (np.random.default_rng([cfg.drop_seed, it])
                if cfg.drop_seed else rng)
    if drop_rng.random() < cfg.skip_drop:
        return np.array([], np.int64)
    if cfg.uniform_drop:
        p = np.full(nt, cfg.drop_rate)
    else:
        w = np.asarray(tree_weights[:nt], np.float64)
        p = np.minimum(cfg.drop_rate * w * nt / max(w.sum(), 1e-12), 1.0)
    return np.nonzero(drop_rng.random(nt) < p)[0][: cfg.max_drop]


class _Contribs:
    """Per-tree contributions to a score, stacked on the device: row ``t``
    holds tree ``t``'s (n,) leaf values, with its class. The buffer grows
    by doubling, so appending a tree moves no earlier row."""

    def __init__(self, n: int, dev):
        self.buf = torch.zeros((0, n), dtype=torch.float32, device=dev)
        self.cls: List[int] = []

    def __len__(self) -> int:
        return len(self.cls)

    def append(self, cls: int, vec: torch.Tensor) -> None:
        t = len(self.cls)
        if t == self.buf.shape[0]:
            grown = torch.zeros((max(2 * t, 8), self.buf.shape[1]),
                                dtype=torch.float32, device=self.buf.device)
            grown[:t] = self.buf
            self.buf = grown
        self.buf[t] = vec
        self.cls.append(int(cls))

    def weighted(self, weights, k: int) -> torch.Tensor:
        """(n, k): each class's contributions times ``weights`` (one per
        tree, float32), summed."""
        T = len(self.cls)
        w = torch.as_tensor(np.asarray(weights[:T], np.float32),
                            device=self.buf.device)
        cls = np.asarray(self.cls)
        out = torch.zeros((self.buf.shape[1], k), dtype=torch.float32,
                          device=self.buf.device)
        for c in range(k):
            sel = torch.as_tensor(np.nonzero(cls == c)[0],
                                  device=self.buf.device)
            if len(sel):
                out[:, c] = (self.buf[sel] * w[sel, None]).sum(0)
        return out

    def to_host(self) -> list:
        """[(class, (n,) float32 numpy)] in tree order (checkpoints)."""
        rows = self.buf[:len(self.cls)].cpu().numpy()
        return [(c, rows[t].copy()) for t, c in enumerate(self.cls)]

    @classmethod
    def from_host(cls, items, n: int, dev) -> "_Contribs":
        out = cls(n, dev)
        for c, v in items:
            out.append(c, torch.as_tensor(np.asarray(v, np.float32)).to(dev))
        return out


def _per_tree_contribs(booster: Booster, X, n: int, dev) -> _Contribs:
    """Each tree's unweighted output on the rows of ``X`` (rf trees keep
    their 1 / trees-per-class average), as the JAX package recovers a warm
    start's prior trees for DART and RF validation."""
    out = _Contribs(n, dev)
    if not booster.trees:
        return out
    Xb = torch.as_tensor(np.asarray(X, np.float32)).to(booster.device)
    leaves = forest_leaves(booster.forest(), Xb, booster._depth_cache).to(
        device=dev, dtype=torch.int64)
    scale = np.ones(1, np.float32)
    if booster.average_output:
        scale = scale / booster.trees_per_class
    for t, tree in enumerate(booster.trees):
        lv = torch.as_tensor(np.asarray(tree.leaf_value, np.float32) * scale,
                             device=dev)
        out.append(t % booster.models_per_iter, lv[leaves[:, t]])
    return out


def _multiprocess_refusals(cfg: BoosterConfig, **args) -> None:
    """The JAX package's refusals of multi-process training."""
    unsupported = [name for name, v in args.items() if v is not None]
    if unsupported or cfg.boosting_type == "dart" \
            or cfg.tree_learner in ("voting", "feature"):
        raise NotImplementedError(
            "multi-process training currently supports the fused path "
            f"only (gbdt/goss/rf, serial learner); got {unsupported or cfg}")


def _multiprocess_mapper(X: np.ndarray, cfg: BoosterConfig,
                         mapper: Optional[BinMapper], categorical_features,
                         mesh) -> BinMapper:
    """The bin mapper of a multi-process fit, the same on every process:
    without ``mapper`` boundaries from a sample gathered in rank order
    (``ceil(bin_sample_count / nproc)`` rows drawn by each process with
    ``default_rng(cfg.seed)``), NaN bins elected over every process's full
    rows and categorical presence OR-ed over them; an explicit ``mapper``
    is rank 0's, refused when another process has NaNs it has no bin for."""
    from ..parallel.mesh import host_copy, local_mesh_devices, process_count

    local_mesh_devices(mesh)        # the mesh spans every process evenly
    nproc = process_count()
    nfeat = X.shape[1]
    has_nan_g = host_copy(np.isnan(X).any(axis=0)[None]).any(axis=0)
    if mapper is None:
        per = max(1, min(X.shape[0], -(-cfg.bin_sample_count // nproc)))
        sub = np.random.default_rng(cfg.seed).choice(X.shape[0], size=per,
                                                     replace=False)
        X_samp = host_copy(np.ascontiguousarray(X[np.sort(sub)]))
        cat_presence_g = None
        if categorical_features:
            from ..ops.quantize import cat_presence_bitmap

            pres_l = np.zeros((nfeat, cfg.max_bin), np.uint8)
            for cj in categorical_features:
                pres_l[cj] = cat_presence_bitmap(X[:, cj], cfg.max_bin)
            cat_presence_g = host_copy(pres_l[None]).any(0)
        return compute_bin_mapper(
            X_samp, cfg.max_bin, cfg.bin_sample_count, categorical_features,
            cfg.seed, has_nan=has_nan_g, min_data_in_bin=cfg.min_data_in_bin,
            max_bin_by_feature=cfg.max_bin_by_feature,
            cat_presence=cat_presence_g)
    # rank 0's mapper, broadcast
    import torch.distributed as dist

    obj = [(np.asarray(mapper.boundaries), np.asarray(mapper.num_bins),
            np.asarray(mapper.is_categorical), np.asarray(mapper.nan_mask))]
    dist.broadcast_object_list(obj, src=0)
    bnd, nb_, cat_, hn_ = obj[0]
    if (has_nan_g & ~np.asarray(hn_)).any():
        raise ValueError(
            "explicit mapper lacks NaN bins for features with missing "
            "values on some process; pass mapper=None so boundaries "
            "are sampled across all processes")
    return BinMapper(boundaries=np.asarray(bnd), num_bins=np.asarray(nb_),
                     is_categorical=np.asarray(cat_), max_bin=mapper.max_bin,
                     has_nan=np.asarray(hn_))


def _original_rows(n: int, n_orig: int, nproc: int) -> np.ndarray:
    """Global indices of the original (unpadded) rows among ``n`` padded
    rows laid out as ``nproc`` equal process blocks of ``n_orig`` original
    rows each (one block when ``nproc`` is 1)."""
    blk = n // nproc
    return np.concatenate([np.arange(p * blk, p * blk + n_orig)
                           for p in range(nproc)])


def _repad(a, keep: np.ndarray, n: int) -> np.ndarray:
    """Rows ``a`` of the original rows back at ``keep`` among ``n`` rows,
    zero elsewhere: padding rows carry no bag and no weight, so their
    values never reach a histogram or a leaf."""
    from ..core.checkpoint import CheckpointError

    a = np.asarray(a, np.float32)
    if a.shape[0] != keep.shape[0]:
        raise CheckpointError(
            f"snapshot has {a.shape[0]} rows but this run has "
            f"{keep.shape[0]} original rows; the snapshot belongs to "
            "different data")
    out = np.zeros((n,) + a.shape[1:], np.float32)
    out[keep] = a
    return out


def train_booster(
    X,
    y: Optional[np.ndarray],
    config: BoosterConfig,
    sample_weight: Optional[np.ndarray] = None,
    init_score: Optional[np.ndarray] = None,
    categorical_features: Optional[Sequence[int]] = None,
    group_sizes: Optional[np.ndarray] = None,
    valid: Optional[tuple] = None,
    fobj: Optional[Callable] = None,
    feature_names: Optional[List[str]] = None,
    init_model: Optional[Booster] = None,
    callbacks: Optional[List[Callable]] = None,
    mapper: Optional[BinMapper] = None,
    mesh=None,
    measures=None,
    checkpoint_store=None,
    checkpoint_every: int = 0,
    resume: bool = True,
    device=DEFAULT_DEVICE,
) -> Booster:
    """Fit a forest on ``X`` (dense (N, F) floats, a scipy sparse matrix or
    a :class:`Dataset`) and labels ``y`` on ``device``. A
    :class:`~synapseml_tpu_torch.gbdt.stream.StreamedDataset` trains out of
    core through ``train_booster_streamed`` (its labels and weights come
    with the stream).

    * ``categorical_features``: column indices binned as categories (their
      integer values; see ``ops.quantize``) and split by category sets
      (``grower``). Sparse rows bin through ``Dataset`` (``bin_sparse``)
      into bitwise the dense rows' bins.

    * ``valid=(Xv, yv)``, or ``(Xv, yv, wv_or_None, group_sizes_v)`` for
      ranking metrics: binned with the training mapper; its score stays on
      the device and each new tree adds to it through a binned traversal.
      The metric (``config.metric``, else the objective's default) is read
      once per iteration (one host sync, counted); ``best_iteration`` and
      ``best_score`` keep the first best. With
      ``config.early_stopping_round`` the fit stops once that many
      iterations pass without an improvement above
      ``config.improvement_tolerance``, and the trees after the best
      iteration are dropped.
    * ``init_model``: warm start. Its trees keep their thresholds and
      missing types; the score starts from its raw score (every
      iteration); ``best_iteration`` counts its iterations too.
    * ``fobj(score, label, weight) -> (grad, hess)``: a custom objective.
      It takes torch tensors on the fit device: score (N,) float32, or
      (N, K) for K classes, the labels and the sample weights (N,); it
      returns grad and hess of N (N*K) float32 values each. A wrong count
      raises ``ValueError``.
    * ``checkpoint_store`` (a :class:`CheckpointStore` or a directory):
      a snapshot every ``checkpoint_every`` iterations (default 10) of the
      trees, score, validation score and best metric; with ``resume`` a
      rerun of the same call continues from the newest snapshot of the
      same run.
    * ``callbacks``: ``cb(iteration, trees)`` after each iteration.
    * sampling and constraints (``boosting_type`` goss / dart / rf, the
      bagging and feature fractions and their seeds, DART's drop params,
      ``monotone_constraints``): the JAX package's draws (module
      docstring); none adds a host sync.

    * ``mesh``: a ``parallel.make_mesh`` mesh with a ``data`` axis; every
      rank of the world calls with the same arguments and gets the same
      booster (module docstring); in a multi-process world each passes
      its own rows instead. ``device`` must be of the mesh's kind; the fit
      runs on the mesh's device.

    ``Booster.metadata["host_syncs"]`` counts device→host reads of the
    growth loop (the grower modules state how many a tree costs, plus one
    per iteration for the validation metric)."""
    from ..core.logging import InstrumentationMeasures

    cfg = config
    # a StreamedDataset carries its own labels and weights and trains
    # through the streamed grower (local import: stream imports this module)
    from .stream import StreamedDataset, train_booster_streamed

    if isinstance(X, StreamedDataset):
        unsupported = [name for name, v in [
            ("y", y), ("sample_weight", sample_weight),
            ("init_score", init_score), ("group_sizes", group_sizes),
            ("fobj", fobj), ("init_model", init_model),
            ("callbacks", callbacks or None)]
            if v is not None]
        if unsupported:
            raise NotImplementedError(
                f"train_booster(StreamedDataset) does not take {unsupported}"
                ": labels and weights ride the stream; the others are the "
                "resident path's (see gbdt/stream.py)")
        if mapper is not None and X.mapper is None:
            X.mapper = mapper
            X._user_mapper = True
        if categorical_features is not None and X.categorical_features is None:
            X.categorical_features = list(categorical_features)
        return train_booster_streamed(
            X, config, mesh=mesh, valid_data=valid, measures=measures,
            checkpoint_store=checkpoint_store,
            checkpoint_every=checkpoint_every, resume=resume,
            feature_names=feature_names, device=device)
    _reject_unported(cfg)
    from ..parallel.mesh import process_count

    # multi-controller (parallel.initialize_distributed): X and y are this
    # process's own rows; the fit is the mesh fit of the rows of every
    # process in rank order
    multiproc = mesh is not None and process_count() > 1
    if multiproc:
        _multiprocess_refusals(cfg, fobj=fobj, callbacks=callbacks or None,
                               init_model=init_model, valid=valid,
                               init_score=init_score, group_sizes=group_sizes)
    if measures is None:
        measures = InstrumentationMeasures()
    dev = resolve_device(device)
    if mesh is not None:
        if mesh.device.type != dev.type:
            raise ValueError(f"train_booster(device={device!r}) on a mesh of "
                             f"{mesh.device}")
        dev = mesh.device
    fit_t0 = _time.perf_counter()
    ckpt_store = checkpoint_store
    if isinstance(ckpt_store, str):
        from ..core.checkpoint import CheckpointStore

        ckpt_store = CheckpointStore(ckpt_store)
    if ckpt_store is not None and checkpoint_every <= 0:
        checkpoint_every = 10

    binned = None
    if _is_sparse(X) and multiproc:
        X = _densify(X)
    if _is_sparse(X):
        if init_model is not None:
            # the warm start's model scores raw rows
            X = _densify(X)
        else:
            # rows bin chunk by chunk from the CSR entries (the JAX package
            # samples the boundaries with cfg.seed on this path)
            X = X.tocsr()
            if mapper is None:
                with measures.span("referenceDataset"):
                    mapper = sparse_bin_mapper(
                        X, cfg.max_bin, cfg.bin_sample_count,
                        categorical_features, cfg.seed,
                        cfg.min_data_in_bin, cfg.max_bin_by_feature)
            with measures.span("dataPreparation"):
                X = Dataset(X, mapper=mapper, max_bin=cfg.max_bin,
                            categorical_features=categorical_features,
                            device=dev)
    if isinstance(X, Dataset):
        if y is None:
            y = X.label
        if sample_weight is None:
            sample_weight = X.weight
        if init_score is None:
            init_score = X.init_score
        if group_sizes is None:
            group_sizes = X.group_sizes
        if categorical_features is None:
            categorical_features = X.categorical_features
        if ((mapper is None or mapper is X.mapper) and init_model is None
                and not multiproc):
            mapper = X.mapper
            binned = X.binned.to(dev)
        else:
            # another mapper, or a warm start (its model scores raw rows)
            mapper = X.mapper if mapper is None else mapper
            X = X.raw_dense()
            if X is None:
                raise ValueError("Dataset was built with keep_raw=False; "
                                 "binning under another mapper and warm "
                                 "starts need raw rows")
        n_orig, nfeat = (X.shape if binned is None else binned.shape)
    else:
        X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError(f"training data must be a non-empty 2-D matrix, got shape {X.shape}")
        n_orig, nfeat = X.shape
    if y is None:
        raise ValueError("no label: pass y explicitly or build the Dataset "
                         "with label=...")
    y = np.asarray(y, np.float32)
    if len(y) != n_orig:
        raise ValueError(f"label length {len(y)} != row count {n_orig}")
    w = (np.ones(n_orig, np.float32) if sample_weight is None
         else np.asarray(sample_weight, np.float32))

    if multiproc:
        with measures.span("referenceDataset"):
            mapper = _multiprocess_mapper(X, cfg, mapper,
                                          categorical_features, mesh)
    elif mapper is None:
        with measures.span("referenceDataset"):
            mapper = compute_bin_mapper(
                X, cfg.max_bin, cfg.bin_sample_count, categorical_features,
                (cfg.seed if cfg.data_random_seed is None
                 else int(cfg.data_random_seed)),
                min_data_in_bin=cfg.min_data_in_bin,
                max_bin_by_feature=cfg.max_bin_by_feature)
    if mapper.max_bin != cfg.max_bin:
        raise ValueError(
            f"bin mapper has max_bin={mapper.max_bin} but config.max_bin="
            f"{cfg.max_bin}; rebuild the Dataset/mapper with the matching "
            "max_bin")
    # a mesh: rows padded to a multiple of the data axis (the last row
    # repeated, label / weight / valid mask 0), each rank's block of them
    # binned and kept on its device
    n, block, valid_mask = n_orig, None, None
    nproc = 1
    if mesh is not None:
        from ..parallel.mesh import (DATA_AXIS, assert_equal_across_processes,
                                     check_same_inputs, row_block)

        ndata = int(mesh.shape[DATA_AXIS])
        if multiproc:
            # each process pads its own rows to its share of the data axis
            nproc = process_count()
            assert_equal_across_processes((n_orig, nfeat),
                                          "local row count / feature count")
            check_same_inputs(mesh, "config",
                              sorted(dataclasses.asdict(cfg).items()))
            if ndata % nproc:
                raise ValueError(f"data axis ({ndata}) must divide evenly "
                                 f"across {nproc} processes")
            ndata //= nproc
        else:
            check_same_inputs(mesh, "data shape, config and labels",
                              (n_orig, nfeat),
                              sorted(dataclasses.asdict(cfg).items()), y)
        rem = (-n_orig) % ndata
        valid_mask = torch.ones(n_orig)
        if rem:
            if binned is not None:
                binned = torch.cat([binned,
                                    binned[-1:].expand(rem, nfeat)])
            if not isinstance(X, Dataset):
                X = np.concatenate([X, np.repeat(X[-1:], rem, axis=0)])
            y = np.concatenate([y, np.zeros(rem, np.float32)])
            w = np.concatenate([w, np.zeros(rem, np.float32)])
            if init_score is not None:
                init_score = np.concatenate(
                    [np.asarray(init_score, np.float32).reshape(n_orig, -1),
                     np.zeros((rem, int(np.size(init_score)) // n_orig),
                              np.float32)])
            valid_mask = torch.cat([valid_mask, torch.zeros(rem)])
            n = n_orig + rem
        if multiproc:
            # n is global from here on: every process's rows in rank order
            # (its block of the mesh); the O(N) vectors are gathered whole
            from ..parallel.mesh import host_copy

            local_rows = X
            y, w, valid_mask = host_copy((y, w, valid_mask))
            valid_mask = torch.as_tensor(valid_mask)
            n = n * nproc
        valid_mask = (valid_mask.to(dev) if bool((valid_mask == 0).any())
                      else None)
        block = slice(*row_block(n, mesh))
    with measures.span("dataPreparation"):
        if binned is None:
            binned = apply_bins(mapper, local_rows if multiproc
                                else X if block is None else X[block], dev)
        elif block is not None:
            binned = binned[block].clone()
        bT = transpose_bins(binned)          # one per fit, read by every tree

    k = cfg.num_class if cfg.objective in MULTICLASS else 1
    obj = (_ranking_objective(cfg, y, group_sizes)
           if cfg.objective == "lambdarank" else _objective(cfg, k))
    _check_sampling_config(cfg)
    rf_mode, dart_mode = cfg.boosting_type == "rf", cfg.boosting_type == "dart"
    yj = torch.as_tensor(y).to(dev)
    wj = torch.as_tensor(w).to(dev)
    base = (np.atleast_1d(np.asarray(obj.init_score(yj, wj).cpu(), np.float64))
            if cfg.boost_from_average else np.zeros(max(k, 1)))
    trees: List[TreeArrays] = []
    tree_weights: List[float] = []
    init_thr = init_mt = None
    if init_model is not None:
        if init_model.models_per_iter != k:
            raise ValueError(
                f"init_model has {init_model.models_per_iter} trees per "
                f"iteration, this config {k}")
        # the init trees keep the thresholds and missing types of their
        # own mapper (or their model string); new trees take None slots,
        # resolved from this fit's mapper
        trees = list(init_model.trees)
        tree_weights = list(init_model.tree_weights)
        base = init_model.base_score
        init_thr = [init_model._thresholds(i) for i in range(len(trees))]
        init_mt = [init_model._missing_types(i) for i in range(len(trees))]
    # (n, K): the base score of each class (and init_score), the margin
    # DART rebuilds its score from
    init_margin = torch.as_tensor(base[:k].astype(np.float32)).to(dev).repeat(
        n, 1)
    if init_score is not None:
        extra = torch.as_tensor(
            np.asarray(init_score, np.float32).reshape(n, -1)).to(dev)
        init_margin = init_margin + extra
    if init_model is None:
        score = init_margin.clone()
    else:
        score = _scores_of(init_model, X, k, dev)
        if init_score is not None:
            score = score + extra
    n_init_trees = len(trees)
    # dart: every tree's training contribution (a warm start's too: they
    # are drop candidates)
    tree_contribs = (_per_tree_contribs(init_model, X, n, dev)
                     if dart_mode and init_model is not None
                     else _Contribs(n, dev))

    has_valid = valid is not None
    if has_valid:
        Xv = _densify(valid[0])
        yv = np.asarray(valid[1], np.float32)
        nv = Xv.shape[0]
        metric_name = _metric_name(cfg)
        higher_better = metric_name.split("@")[0] in HIGHER_IS_BETTER
        gidx_v = None
        if _is_rank_metric(metric_name):
            if len(valid) < 4:
                raise ValueError("ranking validation requires "
                                 "valid=(Xv, yv, wv_or_None, group_sizes_v)")
            gidx_v = make_grouped(yv, valid[3])
        with measures.span("dataPreparation"):
            binned_v = apply_bins(mapper, Xv, dev)
        nan_bins_v = torch.as_tensor(np.asarray(mapper.nan_bins, np.int64),
                                     device=dev)
        yv_j = torch.as_tensor(yv).to(dev)
        # validation weights move to the device once
        wv_j = (torch.as_tensor(np.asarray(valid[2], np.float32)).to(dev)
                if len(valid) > 2 and valid[2] is not None else None)
        score_v = (_scores_of(init_model, Xv, k, dev)
                   if init_model is not None else
                   torch.as_tensor(base[:k].astype(np.float32)).to(dev)
                   .repeat(nv, 1))
        best_metric, best_iter = None, -1
        history: List[float] = []
        # dart / rf: per-tree validation contributions, summed with the
        # current weights each iteration
        valid_contribs = (_per_tree_contribs(init_model, Xv, nv, dev)
                          if (rf_mode or dart_mode) and init_model is not None
                          else _Contribs(nv, dev))

    is_cat = np.asarray(mapper.is_categorical, bool)
    # the wire and the learner resolve before the grower config: the
    # learner decides the grower's reduction (feature = owned-feature
    # reduce-scatter); the resolved values land on cfg, as in the JAX
    # package, and the decisions in Booster.metadata
    autoconfig_info = {}
    if cfg.hist_allreduce_dtype == "auto":
        from .grower import resolve_wire_dtype

        wd, wdec = resolve_wire_dtype(cfg, mesh, n, nfeat)
        cfg.hist_allreduce_dtype = wd
        autoconfig_info["wire_dtype"] = wdec.provenance()
    routing_info = None
    if cfg.tree_learner == "auto":
        cfg.tree_learner, routing_info = _auto_route(
            cfg, mesh, binned, nfeat, n, bool(is_cat.any()), multiproc)
    n_workers = 1 if mesh is None else int(mesh.shape.get("data", 1))
    feature_shards = 1
    if cfg.tree_learner == "feature" and n_workers > 1:
        from ..ops.hist_kernel import features_padded

        feature_shards = n_workers
        if features_padded(nfeat) % feature_shards:
            import warnings

            warnings.warn(
                f"tree_learner='feature': features_padded({nfeat})="
                f"{features_padded(nfeat)} is not divisible by the "
                f"{feature_shards}-way data axis of this mesh; falling back "
                "to data-parallel histograms")
            cfg.tree_learner, feature_shards = "data", 1
            if routing_info is not None:
                routing_info = dict(routing_info, tree_learner="data",
                                    fallback="feature_shards_indivisible")
    # as in the JAX package, a one-rank mesh elects its columns too
    voting = (cfg.tree_learner == "voting" and mesh is not None
              and nfeat > 2 * cfg.top_k)
    grower_cfg = cfg.grower(has_categorical=bool(is_cat.any()),
                            feature_shards=feature_shards)
    # each categorical feature's DISTINCT category count picks one-vs-rest
    # (a mapper without cat_counts falls back to its bin count)
    cc = (np.asarray(mapper.cat_counts, np.int32)
          if mapper.cat_counts is not None
          else np.asarray(mapper.num_bins, np.int32) - 1)
    cat_nbins = np.where(is_cat, cc, np.int32(0x7FFF))
    nan_bins = np.asarray(mapper.nan_bins, np.int32)
    mono = np.zeros(nfeat, np.int32)
    if cfg.monotone_constraints is not None:
        mc = np.asarray(cfg.monotone_constraints, np.int32)
        mono[: len(mc)] = mc
    key0 = prng.prng_key(cfg.seed)
    bynode = cfg.feature_fraction_bynode < 1.0
    in_bag_cur = (torch.ones(n, dtype=torch.float32, device=dev)
                  if valid_mask is None else valid_mask.clone())
    # DART's drop decisions (host numpy, as in the JAX package)
    rng = np.random.default_rng(cfg.seed)
    stats = {"host_syncs": 0}

    start_it = 0
    if ckpt_store is not None:
        from ..core.checkpoint import CheckpointError, preemption_point

        # the original rows identify the run (snapshots hold them alone, in
        # global row order), so a snapshot resumes on any mesh or process
        # count: the padding depends on the mesh
        keep = _original_rows(n, n_orig, nproc)
        fingerprint = _train_fingerprint(cfg, len(keep), nfeat, y[keep],
                                         n_init_trees)
        state = _ckpt_load_gbdt(ckpt_store, fingerprint) if resume else None
        if state is not None:
            start_it = int(state["iteration"])
            trees = list(state["trees"])
            tree_weights = list(state["tree_weights"])
            score = torch.as_tensor(_repad(state["score"], keep, n)).to(dev)
            in_bag_cur = torch.as_tensor(
                _repad(state["in_bag_cur"], keep, n)).to(dev)
            tree_contribs = _Contribs.from_host(
                [(c, _repad(v, keep, n)) for c, v in state["tree_contribs"]],
                n, dev)
            rng = state["rng"]
            if has_valid:
                sv = np.asarray(state["score_v"], np.float32)
                if sv.shape != tuple(score_v.shape):
                    raise CheckpointError(
                        f"validation score shape changed {sv.shape} -> "
                        f"{tuple(score_v.shape)}; resume with the original "
                        "validation set (or pass resume=False)")
                score_v = torch.as_tensor(sv).to(dev)
                valid_contribs = _Contribs.from_host(
                    state["valid_contribs"], nv, dev)
                best_metric = state["best_metric"]
                best_iter = int(state["best_iter"])
                history = list(state["history"])

    done = start_it
    from ..parallel.elastic import current_watchdog

    wd = current_watchdog()
    with measures.span("trainingIterations"):
        for it in range(start_it, cfg.num_iterations):
            if ckpt_store is not None:
                preemption_point("gbdt.iteration", it)
            if wd is not None:
                wd.beat("gbdt.iteration", it)
            # dart: drop trees and take their weighted contributions out of
            # the score the gradients see
            drop, score_it = (), score
            if dart_mode and trees:
                drop = _dart_drops(cfg, rng, it, tree_weights)
                if len(drop):
                    dropped = torch.zeros_like(score)
                    for j in drop:
                        # the weight rounded to float32, as the JAX
                        # package multiplies it into a float32 array
                        dropped[:, tree_contribs.cls[j]] += (
                            tree_contribs.buf[j]
                            * float(np.float32(tree_weights[j])))
                    score_it = score - dropped
            kdrop = len(drop)
            # every class's gradients once per iteration, as (K, n) rows so
            # that each tree reads a contiguous one
            if fobj is not None:
                g, h = _custom_grad_hess(fobj, score_it, yj, wj, n, k)
            else:
                g, h = obj.grad_hess(score_it[:, 0] if k == 1 else score_it,
                                     yj, wj)
            g = g.reshape(n, k).t().contiguous()
            h = h.reshape(n, k).t().contiguous()
            with measures.span("sampling"):
                in_bag, g, h, in_bag_cur = _sample_rows_impl(
                    cfg, n, key0, it, g, h, in_bag_cur, yj, valid_mask)
                feature_active = _sample_features_impl(cfg, nfeat, key0,
                                                       it, dev)
            new_weight = 1.0
            if kdrop:
                new_weight = (1.0 / (kdrop + cfg.learning_rate)
                              if cfg.xgboost_dart_mode
                              else 1.0 / (kdrop + 1.0))
            for c in range(k):
                def grow(c=c):
                    tree, node = _grow_one(
                        binned, bT, g[c], h[c], in_bag, feature_active,
                        grower_cfg, cfg, block, mesh, voting, stats=stats,
                        nan_bins=nan_bins, monotone=mono,
                        is_categorical=is_cat, cat_nbins=cat_nbins,
                        node_key=(_node_key_data(key0, it, c) if bynode
                                  else None))
                    if block is not None:
                        # every rank's block of leaves, for the whole score
                        with measures.span("nodeGather"):
                            node = allgather(node, mesh.group("data"),
                                             tiled=True)
                    return tree, node

                if wd is not None:
                    # the tree's collectives and host syncs under the stall
                    # guard: a hung peer surfaces as PeerLostError
                    from ..core.device import on_device_thread

                    tree, node = wd.run(on_device_thread(dev, grow),
                                        op="gbdt.chunk")
                else:
                    tree, node = grow()
                contrib = tree.leaf_value[node]
                if dart_mode:
                    tree_contribs.append(c, contrib)
                    if kdrop and c == k - 1:
                        # dropped trees scaled by kdrop / (kdrop + 1), then
                        # the score rebuilt from the margin and every
                        # weighted contribution (this iteration's trees at
                        # the new weight)
                        factor = (kdrop / (kdrop + cfg.learning_rate)
                                  if cfg.xgboost_dart_mode
                                  else kdrop / (kdrop + 1.0))
                        for j in drop:
                            tree_weights[j] *= factor
                        wts = tree_weights + [new_weight] * (
                            len(tree_contribs) - len(tree_weights))
                        score = init_margin + tree_contribs.weighted(wts, k)
                    elif not kdrop:
                        score[:, c] += contrib
                elif not rf_mode:
                    # rf: gradients always from the base score
                    score[:, c] += contrib
                trees.append(tree)
                tree_weights.append(new_weight)
                if has_valid:
                    with measures.span("validation"):
                        leaf_v = tree_leaves_binned(tree, binned_v,
                                                    nan_bins_v)
                        contrib_v = tree.leaf_value[leaf_v]
                        if rf_mode or dart_mode:
                            valid_contribs.append(c, contrib_v)
                        else:
                            score_v[:, c] += contrib_v
            done = it + 1
            if has_valid:
                with measures.span("validation"):
                    raw_v = score_v
                    if rf_mode or dart_mode:
                        wts_v = np.asarray(tree_weights, np.float32)
                        if rf_mode:
                            wts_v = wts_v / max(len(trees) // k, 1)
                        raw_v = (torch.as_tensor(base[:k].astype(np.float32))
                                 .to(dev).repeat(nv, 1)
                                 + valid_contribs.weighted(wts_v, k))
                    pred_v = obj.transform(raw_v[:, 0] if k == 1 else raw_v)
                    mval = float(_eval_metric(metric_name, yv_j, pred_v,
                                              raw_v, gidx_v, cfg, wv_j))
                stats["host_syncs"] += 1
                history.append(mval)
                tol = cfg.improvement_tolerance
                if (best_metric is None
                        or (mval > best_metric + tol if higher_better
                            else mval < best_metric - tol)):
                    best_metric, best_iter = mval, it
                if (cfg.early_stopping_round > 0
                        and it - best_iter >= cfg.early_stopping_round):
                    # best_iter counts new iterations: keep every
                    # warm-start tree
                    cut = n_init_trees + (best_iter + 1) * k
                    trees, tree_weights = trees[:cut], tree_weights[:cut]
                    break
            if callbacks:
                for cb in callbacks:
                    cb(it, trees)
            if ckpt_store is not None and (it + 1) % checkpoint_every == 0:
                trees = trees_to_host(trees)
                # on a mesh rank 0 commits and every rank waits until it has
                # (a rank that resumes must find the snapshot)
                if mesh is None or mesh.rank == 0:
                    payload = {"iteration": it + 1, "trees": trees,
                               "tree_weights": list(tree_weights),
                               "score": score.cpu().numpy()[keep],
                               "in_bag_cur": in_bag_cur.cpu().numpy()[keep],
                               "tree_contribs": [
                                   (c, v[keep]) for c, v
                                   in tree_contribs.to_host()],
                               "rng": rng}
                    if has_valid:
                        payload.update(
                            score_v=score_v.cpu().numpy(),
                            valid_contribs=valid_contribs.to_host(),
                            best_metric=best_metric, best_iter=best_iter,
                            history=history)
                    _ckpt_save_gbdt(ckpt_store, it + 1, payload,
                                    fingerprint, measures)
                if mesh is not None:
                    torch.distributed.barrier(group=mesh.world_group)
        # one batched device→host transfer of every tree's leaf fields; it
        # waits for the device, so the span ends with the work done
        trees = trees_to_host(trees)
    measures.count("iterations", done - start_it)
    merged_thr = merged_mt = None
    if init_thr is not None:
        pad = [None] * max(len(trees) - len(init_thr), 0)
        merged_thr = (init_thr + pad)[: len(trees)]
        merged_mt = (init_mt + pad)[: len(trees)]
    metadata = {"host_syncs": stats["host_syncs"], "device": str(dev),
                "observed_fit_s": round(_time.perf_counter() - fit_t0, 6),
                "measures": measures.report()}
    if has_valid:
        metadata["valid_metric"] = {"name": metric_name, "values": history}
    if routing_info:
        metadata["routing"] = routing_info
    if autoconfig_info:
        autoconfig_info["observed_fit_s"] = metadata["observed_fit_s"]
        metadata["autoconfig"] = autoconfig_info
    # best_iter counts new iterations; best_iteration addresses the whole
    # returned forest, so warm-start iterations offset it
    return Booster(mapper, cfg, trees, tree_weights, base, feature_names,
                   best_iteration=(n_init_trees // max(k, 1) + best_iter
                                   if has_valid else -1),
                   thresholds=merged_thr, missing_types=merged_mt,
                   best_score=(best_metric if has_valid else None),
                   metadata=metadata, device=dev)
