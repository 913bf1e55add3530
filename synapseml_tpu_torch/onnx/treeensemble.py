"""Trained GBDT Booster → ONNX TreeEnsemble graph.

The port's counterpart of the JAX package's ``onnx/treeensemble.py``, over
the port's ``Booster``: the same trees give the same bytes.

The reference ecosystem's documented serving path for LightGBM models is
train → ``onnxmltools.convert_lightgbm`` → ONNXModel inference (reference:
website "Quickstart - ONNX Model Inference" notebook, which pip-installs
onnxmltools). This module is the native analog: it serializes a trained
:class:`~synapseml_tpu_torch.gbdt.boosting.Booster` into an ``ai.onnx.ml``
TreeEnsembleClassifier / TreeEnsembleRegressor graph that both this repo's
executor (onnx/ops.py) and standard ONNX runtimes understand, so a GBDT
model can ride the same ONNXModel serving surface as any deep model.

Emission choices (spec-clean, exactly matching Booster.predict):
  * binary       → Classifier, per-leaf class-1 weights, base_values
                   [0, base], post_transform SOFTMAX (softmax([0, s]) ==
                   sigmoid(s), so probabilities match bit-for-tolerance)
  * multiclass   → Classifier, tree t contributes to class t % k,
                   post_transform SOFTMAX
  * regression   → Regressor, SUM aggregate, raw ensemble output (link
                   functions like poisson's exp are NOT applied — same as
                   LightGBM's own converter)
Categorical splits and rf (average_output) are rejected: BRANCH_EQ cannot
express LightGBM bitset membership, and averaged output has no faithful
TreeEnsemble encoding.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..gbdt.model_io import _tree_dump_seq
from .modelgen import _attr, _vi
from .protoio import Attribute, Graph, Model, Node


def _strs_attr(name: str, values: List[str]) -> Attribute:
    return Attribute(name=name, type=8,
                     strings=[v.encode() for v in values])


def booster_to_onnx(booster, input_name: str = "input",
                    num_iteration: int = -1) -> Model:
    """Serialize a trained Booster as an ONNX TreeEnsemble model.

    Outputs: classifier graphs expose ``label`` (int64) and
    ``probabilities`` (N, num_class); regressor graphs expose ``variable``
    (N, 1) — the onnxmltools naming, so downstream column wiring written
    for converted LightGBM models ports over unchanged.
    """
    cfg = booster.config
    if booster.average_output:
        raise NotImplementedError(
            "booster_to_onnx: rf/average_output has no faithful "
            "TreeEnsemble encoding (weights are averaged, not summed)")
    if int(getattr(cfg, "start_iteration", 0)) > 0:
        raise NotImplementedError(
            "booster_to_onnx: start_iteration prediction windows are not "
            "expressible in a TreeEnsemble (every tree contributes)")
    objective = cfg.objective
    classifier = objective in ("binary", "multiclass", "softmax",
                               "multiclassova")
    # sigmoid-family objectives apply sigmoid(cfg.sigmoid * raw); the graph
    # has no sigmoid-slope attribute, so the slope is folded into every leaf
    # weight and base value instead (probabilities then match exactly)
    ova = objective == "multiclassova"
    slope = float(cfg.sigmoid) if objective == "binary" or ova else 1.0
    k = booster.models_per_iter
    n_features = booster.mapper.num_features

    nodes_treeids: List[int] = []
    nodes_nodeids: List[int] = []
    nodes_featureids: List[int] = []
    nodes_values: List[float] = []
    nodes_modes: List[str] = []
    nodes_true: List[int] = []
    nodes_false: List[int] = []
    nodes_miss: List[int] = []
    leaf_treeids: List[int] = []
    leaf_nodeids: List[int] = []
    leaf_outids: List[int] = []
    leaf_weights: List[float] = []

    for ti, tree, thr, weight, _base_shift in _tree_dump_seq(
            booster, num_iteration):
        ns = int(tree.num_splits)
        if ns and np.asarray(tree.split_type)[:ns].any():
            raise NotImplementedError(
                "booster_to_onnx: categorical splits cannot be expressed "
                "as TreeEnsemble BRANCH_* modes (LightGBM's own converter "
                "has the same limitation)")
        out_id = ti % k if classifier and k > 1 else (
            1 if classifier else 0)
        lv = np.asarray(tree.leaf_value, np.float64) * float(weight) * slope
        if ns == 0:
            # single-leaf tree: one LEAF node, id 0
            nodes_treeids.append(ti)
            nodes_nodeids.append(0)
            nodes_featureids.append(0)
            nodes_values.append(0.0)
            nodes_modes.append("LEAF")
            nodes_true.append(0)
            nodes_false.append(0)
            nodes_miss.append(0)
            leaf_treeids.append(ti)
            leaf_nodeids.append(0)
            leaf_outids.append(out_id)
            leaf_weights.append(float(lv[0]))
            continue
        sf = np.asarray(tree.split_feature)[:ns]
        th = np.asarray(thr, np.float64)[:ns]
        dl = np.asarray(tree.default_left)[:ns]
        lc = np.asarray(tree.left_child)[:ns]
        rc = np.asarray(tree.right_child)[:ns]

        def node_id(c: int) -> int:
            # internal i -> i; leaf l (encoded ~l) -> ns + l
            return int(c) if c >= 0 else ns + int(~c)

        for i in range(ns):
            nodes_treeids.append(ti)
            nodes_nodeids.append(i)
            nodes_featureids.append(int(sf[i]))
            # our traversal is x <= thr -> left; +inf thresholds (top-bin
            # sentinel) stay +inf: BRANCH_LEQ with value=inf sends every
            # finite x left, matching the binned path
            nodes_values.append(float(th[i]))
            nodes_modes.append("BRANCH_LEQ")
            nodes_true.append(node_id(int(lc[i])))
            nodes_false.append(node_id(int(rc[i])))
            nodes_miss.append(int(bool(dl[i])))
        for leaf in range(ns + 1):
            nodes_treeids.append(ti)
            nodes_nodeids.append(ns + leaf)
            nodes_featureids.append(0)
            nodes_values.append(0.0)
            nodes_modes.append("LEAF")
            nodes_true.append(ns + leaf)
            nodes_false.append(ns + leaf)
            nodes_miss.append(0)
            leaf_treeids.append(ti)
            leaf_nodeids.append(ns + leaf)
            leaf_outids.append(out_id)
            leaf_weights.append(float(lv[leaf]))

    common = {
        "nodes_treeids": _attr("nodes_treeids", nodes_treeids),
        "nodes_nodeids": _attr("nodes_nodeids", nodes_nodeids),
        "nodes_featureids": _attr("nodes_featureids", nodes_featureids),
        "nodes_values": Attribute(name="nodes_values", type=6,
                                  floats=[float(v) for v in nodes_values]),
        "nodes_modes": _strs_attr("nodes_modes", nodes_modes),
        "nodes_truenodeids": _attr("nodes_truenodeids", nodes_true),
        "nodes_falsenodeids": _attr("nodes_falsenodeids", nodes_false),
        "nodes_missing_value_tracks_true":
            _attr("nodes_missing_value_tracks_true", nodes_miss),
    }
    base = np.asarray(booster.base_score, np.float64) * slope
    if classifier:
        n_class = max(k, 2)
        if k == 1:
            base_values = [0.0, float(base[0])]
        else:
            base_values = [float(b) for b in base[:n_class]]
        attrs = dict(common)
        attrs["classlabels_int64s"] = _attr("classlabels_int64s",
                                            list(range(n_class)))
        attrs["class_treeids"] = _attr("class_treeids", leaf_treeids)
        attrs["class_nodeids"] = _attr("class_nodeids", leaf_nodeids)
        attrs["class_ids"] = _attr("class_ids", leaf_outids)
        attrs["class_weights"] = Attribute(
            name="class_weights", type=6,
            floats=[float(w) for w in leaf_weights])
        attrs["base_values"] = Attribute(
            name="base_values", type=6, floats=base_values)
        # ova applies an UNNORMALIZED per-class sigmoid (objectives.py) —
        # LOGISTIC, not SOFTMAX; binary rides softmax([0, s]) == sigmoid(s)
        attrs["post_transform"] = _attr("post_transform",
                                        "LOGISTIC" if ova else "SOFTMAX")
        node = Node(op_type="TreeEnsembleClassifier", inputs=[input_name],
                    outputs=["label", "probabilities"],
                    name="tree_ensemble", attrs=attrs)
        outputs = [_vi("label", ["N"]), _vi("probabilities", ["N", n_class])]
        outputs[0].elem_type = 7          # int64 labels
    else:
        attrs = dict(common)
        attrs["n_targets"] = _attr("n_targets", 1)
        attrs["target_treeids"] = _attr("target_treeids", leaf_treeids)
        attrs["target_nodeids"] = _attr("target_nodeids", leaf_nodeids)
        attrs["target_ids"] = _attr("target_ids", leaf_outids)
        attrs["target_weights"] = Attribute(
            name="target_weights", type=6,
            floats=[float(w) for w in leaf_weights])
        attrs["base_values"] = Attribute(
            name="base_values", type=6, floats=[float(base[0])])
        attrs["post_transform"] = _attr("post_transform", "NONE")
        attrs["aggregate_function"] = _attr("aggregate_function", "SUM")
        node = Node(op_type="TreeEnsembleRegressor", inputs=[input_name],
                    outputs=["variable"], name="tree_ensemble", attrs=attrs)
        outputs = [_vi("variable", ["N", 1])]
    node.domain = "ai.onnx.ml"

    graph = Graph(nodes=[node], initializers={},
                  inputs=[_vi(input_name, ["N", n_features])],
                  outputs=outputs, name="gbdt_tree_ensemble")
    return Model(graph=graph, opset=17, ml_opset=3)
