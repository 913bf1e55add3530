"""LightGBM-compatible model-string serialization.

A copy of the JAX package's ``gbdt/model_io.py`` (numpy logic; the port
imports nothing of that package), with its JSON dump. A forest trained by
either package writes the same text and the same JSON, byte for byte, when
its arrays agree.

The reference's model artifact IS the LightGBM text model string (saved via
saveNativeModel, LightGBMBooster.scala:458-470; loaded into models at
LightGBMClassifier.scala:196-211). Emitting the same format keeps trained models
interoperable with the LightGBM ecosystem (native lib, treelite, shap, ...), and
lets this framework load models trained elsewhere.

Format notes (LightGBM `tree` v3 text format):
  * child pointers: >= 0 → internal node index, negative → ~leaf_index
  * decision_type bitfield: bit0 categorical, bit1 default_left, bits2-3
    missing_type (0 none, 1 zero, 2 nan). Splits on features with missing
    values emit missing_type=nan plus the LEARNED default_left bit
    (grower.py); features seen without NaN emit missing_type=none.
  * categorical thresholds: `threshold` holds an index into cat_boundaries;
    cat_threshold stores uint32 bitset words.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.device import DEFAULT_DEVICE
from ..ops.quantize import BinMapper
from .grower import TreeArrays

_DT_CAT = 1
_DT_DEFAULT_LEFT = 2
_DT_MISSING_NAN = 8


def _fmt(arr, fmt="{:g}") -> str:
    return " ".join(fmt.format(x) for x in arr)


def _tree_dump_seq(booster, num_iteration: int = -1):
    """Shared per-tree serialization inputs for the text and JSON dumps:
    yields (index, tree, thresholds, weight, base_shift). LightGBM stores no
    base score, so boost_from_average folds into the first tree of each class
    (every tree when the output is averaged — the mean shifts by base)."""
    k = booster.models_per_iter
    trees = booster.trees
    if num_iteration and num_iteration > 0:
        trees = trees[: num_iteration * k]
    for ti, tree in enumerate(trees):
        if booster.average_output:
            base_shift = float(booster.base_score[ti % k])
        elif ti < k:
            base_shift = float(booster.base_score[ti])
        else:
            base_shift = 0.0
        yield ti, tree, booster._thresholds(ti), booster.tree_weights[ti], \
            base_shift


def booster_to_string(booster) -> str:
    cfg = booster.config
    mapper: BinMapper = booster.mapper
    k = booster.models_per_iter
    lines: List[str] = [
        "tree",
        "version=v3",
        f"num_class={booster.num_class}",
        f"num_tree_per_iteration={k}",
        "label_index=0",
        f"max_feature_idx={mapper.num_features - 1}",
        f"objective={_objective_string(cfg)}",
        ("average_output" if booster.average_output else ""),
        "feature_names=" + " ".join(booster.feature_names),
        "feature_infos=" + " ".join(_feature_info(mapper, j) for j in range(mapper.num_features)),
    ]
    lines = [l for l in lines if l != ""]

    tree_blocks = [
        _tree_to_string(ti, tree, thr, w, cfg.learning_rate, base_shift,
                        booster._missing_types(ti))
        for ti, tree, thr, w, base_shift in _tree_dump_seq(booster)]
    sizes = [len(b) + 1 for b in tree_blocks]
    lines.append("tree_sizes=" + " ".join(str(s) for s in sizes))
    lines.append("")
    out = "\n".join(lines) + "\n" + "\n".join(tree_blocks)
    out += "\nend of trees\n\nfeature_importances:\n"
    imp = booster.feature_importances("split")
    order = np.argsort(-imp)
    for j in order:
        if imp[j] > 0:
            out += f"{booster.feature_names[j]}={int(imp[j])}\n"
    out += "\nparameters:\n[boosting: {}]\n[objective: {}]\n[learning_rate: {}]\n[num_leaves: {}]\nend of parameters\n".format(
        cfg.boosting_type, cfg.objective, cfg.learning_rate, cfg.num_leaves)
    out += "\npandas_categorical:null\n"
    return out


def _objective_string(cfg) -> str:
    """Objective + its hyper-parameters, exactly as native LightGBM stores
    them (GBDT::SaveModelToString writes objective->ToString()): loading the
    file elsewhere must reproduce the same link/loss parameters."""
    if cfg.objective == "binary":
        return f"binary sigmoid:{cfg.sigmoid:g}"
    if cfg.objective in ("multiclass", "softmax"):
        return f"multiclass num_class:{cfg.num_class}"
    if cfg.objective == "multiclassova":
        return f"multiclassova num_class:{cfg.num_class} sigmoid:{cfg.sigmoid:g}"
    if cfg.objective == "lambdarank":
        return "lambdarank"
    if cfg.objective == "quantile":
        return f"quantile alpha:{cfg.alpha:g}"
    if cfg.objective == "huber":
        return f"huber alpha:{cfg.alpha:g}"
    if cfg.objective == "fair":
        return f"fair fair_c:{cfg.fair_c:g}"
    if cfg.objective == "poisson":
        return f"poisson max_delta_step:{cfg.poisson_max_delta_step:g}"
    if cfg.objective == "tweedie":
        return (f"tweedie "
                f"tweedie_variance_power:{cfg.tweedie_variance_power:g}")
    if cfg.objective in ("cross_entropy", "xentropy"):
        # native LightGBM stores the canonical name; its model loader does
        # not resolve config-level aliases
        return "cross_entropy"
    return cfg.objective


def _feature_info(mapper: BinMapper, j: int) -> str:
    if mapper.is_categorical[j]:
        nb = int(mapper.num_bins[j])
        return ":".join(str(i) for i in range(max(nb - 1, 1)))
    b = mapper.boundaries[j]
    finite = b[np.isfinite(b)]
    if finite.size == 0:
        return "none"
    return f"[{finite[0]:g}:{finite[-1]:g}]"


def _tree_to_string(index: int, tree: TreeArrays, thresholds: np.ndarray,
                    weight: float, shrinkage: float, base_shift: float = 0.0,
                    missing_types=None) -> str:
    ns = int(tree.num_splits)
    nleaves = ns + 1
    sf = np.asarray(tree.split_feature)[:ns]
    stype = np.asarray(tree.split_type)[:ns]
    dleft = np.asarray(tree.default_left)[:ns]
    thr = np.asarray(thresholds)[:ns].astype(np.float64)
    lc = np.asarray(tree.left_child)[:ns]
    rc = np.asarray(tree.right_child)[:ns]
    lv = np.asarray(tree.leaf_value)[:nleaves].astype(np.float64) * weight + base_shift
    lw = np.asarray(tree.leaf_weight)[:nleaves]
    lcnt = np.asarray(tree.leaf_count)[:nleaves]
    gain = np.asarray(tree.split_gain)[:ns]
    iv = np.asarray(tree.internal_value)[:ns]
    icnt = np.asarray(tree.internal_count)[:ns]
    bits = np.asarray(tree.cat_bitset)[:ns]

    # leaf pointers beyond the actual leaf count can appear when num_splits <
    # num_leaves-1; clamp any dangling internal pointer to a leaf
    def fix_child(c):
        return np.where((c >= 0) & (c < ns), c, np.where(c >= 0, ~0, c))

    lc, rc = fix_child(lc), fix_child(rc)

    # missing codes come from the booster (Booster._missing_types: parsed
    # values for loaded models, NaN-mask-derived otherwise) so a loaded
    # native model's zero/none codes survive a save round trip verbatim
    mt = (np.asarray(missing_types, np.int64)[:ns]
          if missing_types is not None and len(sf)
          else np.zeros(len(sf), np.int64))
    dt = (np.where(stype == 1, _DT_CAT, 0)
          + np.where(dleft, _DT_DEFAULT_LEFT, 0)
          + (np.clip(mt, 0, 3) << 2))

    lines = [f"Tree={index}", f"num_leaves={max(nleaves, 1)}"]
    cat_lines = []
    if (stype == 1).any():
        # threshold for categorical nodes = index into cat_boundaries
        cat_idx = np.cumsum(stype) - 1
        thr = np.where(stype == 1, cat_idx.astype(np.float64), thr)
        bw = bits.shape[1]
        boundaries = [0]
        words: List[int] = []
        for i in range(ns):
            if stype[i] == 1:
                words.extend(int(w) for w in bits[i])
                boundaries.append(len(words))
        cat_lines = [f"num_cat={int((stype == 1).sum())}",
                     "cat_boundaries=" + _fmt(boundaries, "{:d}"),
                     "cat_threshold=" + _fmt(words, "{:d}")]
    else:
        lines.append("num_cat=0")

    if ns == 0:
        # single-leaf tree: LightGBM emits leaf_value only
        lines += cat_lines
        lines.append("leaf_value=" + _fmt(lv, "{:.17g}"))
        lines.append(f"shrinkage={shrinkage:g}")
        return "\n".join(lines) + "\n"

    lines += [
        "split_feature=" + _fmt(sf, "{:d}"),
        "split_gain=" + _fmt(gain),
        "threshold=" + _fmt(thr, "{:.17g}"),
        "decision_type=" + _fmt(dt, "{:d}"),
        "left_child=" + _fmt(lc, "{:d}"),
        "right_child=" + _fmt(rc, "{:d}"),
        "leaf_value=" + _fmt(lv, "{:.17g}"),
        "leaf_weight=" + _fmt(lw),
        "leaf_count=" + _fmt(lcnt, "{:d}"),
        "internal_value=" + _fmt(iv),
        # internal hessian sums are not tracked separately; counts are the
        # closest available weight proxy (harmless to downstream loaders)
        "internal_weight=" + _fmt(np.maximum(icnt.astype(np.float64), 1.0)),
        "internal_count=" + _fmt(icnt, "{:d}"),
    ] + cat_lines + [
        "is_linear=0",
        f"shrinkage={shrinkage:g}",
    ]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Parsing (load models produced by us or by native LightGBM)
# ---------------------------------------------------------------------------

def _hdr_int(hdr, name, default):
    """Header integer with a clear diagnosis on garbage (a torn download or
    binary splice lands here, not in an int() traceback)."""
    try:
        return int(hdr.get(name, default))
    except (TypeError, ValueError):
        raise ValueError(
            f"corrupt LightGBM model string: header field {name!r} is not "
            f"an integer (got {hdr.get(name)!r})") from None


def booster_from_string(s: str, device=DEFAULT_DEVICE):
    from .boosting import Booster, BoosterConfig

    if not s.lstrip().startswith("tree"):
        raise ValueError("not a LightGBM model string (must start with 'tree')")
    header, _, rest = s.partition("\nTree=")
    if not rest:
        raise ValueError("model string contains no trees")
    if "end of trees" not in rest:
        # every writer (ours and native LightGBM's) terminates the tree
        # section; its absence means the file was truncated mid-stream
        raise ValueError(
            "truncated LightGBM model string: missing 'end of trees' "
            "terminator — the file was cut off mid-write or mid-download")
    hdr = {}
    for line in header.splitlines():
        if "=" in line:
            key, _, val = line.partition("=")
            hdr[key.strip()] = val.strip()
    num_class = _hdr_int(hdr, "num_class", 1)
    ntpi = _hdr_int(hdr, "num_tree_per_iteration", 1)
    obj_str = hdr.get("objective", "regression").split()
    objective = obj_str[0] if obj_str else "regression"
    feature_names = hdr.get("feature_names", "").split()
    nfeat = _hdr_int(hdr, "max_feature_idx", len(feature_names) - 1) + 1
    average_output = "average_output" in header

    cfg = BoosterConfig(objective=objective, num_class=num_class,
                        boosting_type="rf" if average_output else "gbdt")
    # objective hyper-parameters (the native writer appends them as
    # name:value tokens — see _objective_string)
    _obj_fields = {"sigmoid": "sigmoid", "alpha": "alpha",
                   "fair_c": "fair_c",
                   "max_delta_step": "poisson_max_delta_step",
                   "tweedie_variance_power": "tweedie_variance_power"}
    for tok in obj_str[1:]:
        name, _, val = tok.partition(":")
        if name in _obj_fields and val:
            try:
                setattr(cfg, _obj_fields[name], float(val))
            except ValueError:
                pass

    trees = []
    max_leaves = 2
    blocks = ("Tree=" + rest).split("\nTree=")
    parsed = []
    for b in blocks:
        if not b.strip() or b.startswith("end of trees"):
            continue
        body = b.split("end of trees")[0]
        fields = {}
        for line in body.splitlines():
            if "=" in line:
                key, _, val = line.partition("=")
                fields[key.strip()] = val.strip()
        parsed.append(fields)
        try:
            nl = int(fields.get("num_leaves", 1))
        except ValueError:
            raise ValueError(
                f"corrupt LightGBM model string: tree {len(parsed) - 1} has "
                f"non-integer num_leaves={fields.get('num_leaves')!r}") \
                from None
        # a split tree with no structure arrays is a torn tree block, not a
        # model (single-leaf trees legitimately carry only leaf_value)
        if nl > 1:
            missing = [f for f in ("split_feature", "threshold", "left_child",
                                   "right_child", "leaf_value")
                       if not fields.get(f)]
            if missing:
                raise ValueError(
                    f"corrupt/truncated LightGBM model string: tree "
                    f"{len(parsed) - 1} declares num_leaves={nl} but lacks "
                    f"required fields {missing}")
        max_leaves = max(max_leaves, nl)

    # bitset width: wide enough for the largest categorical node in the model
    # (native LightGBM models can exceed 256 categories)
    bw = 8
    for fields in parsed:
        if int(fields.get("num_cat", 0)) > 0 and fields.get("cat_boundaries"):
            bounds = np.array(fields["cat_boundaries"].split(), dtype=np.int64)
            if len(bounds) > 1:
                bw = max(bw, int(np.diff(bounds).max()))
    mtypes_all = []
    for tree_idx, fields in enumerate(parsed):
        nleaves = int(fields.get("num_leaves", 1))
        ns = nleaves - 1
        L = max_leaves

        def arr(name, dtype, size, default=0):
            if name in fields and fields[name]:
                try:
                    a = np.array(fields[name].split(), dtype=np.float64)
                except ValueError:
                    raise ValueError(
                        f"corrupt LightGBM model string: tree {tree_idx} "
                        f"field {name!r} contains non-numeric data "
                        f"({fields[name][:60]!r})") from None
            else:
                a = np.full(size, default, np.float64)
            out = np.full(max(size, 1), default, np.float64)
            out[: min(len(a), size)] = a[:size]
            return out.astype(dtype)

        sf = arr("split_feature", np.int32, max(L - 1, 1))
        thr = arr("threshold", np.float32, max(L - 1, 1))
        dt = arr("decision_type", np.int32, max(L - 1, 1))
        lc = arr("left_child", np.int32, max(L - 1, 1), ~0)
        rc = arr("right_child", np.int32, max(L - 1, 1), ~0)
        lv = arr("leaf_value", np.float32, L)
        lw = arr("leaf_weight", np.float32, L)
        lcn = arr("leaf_count", np.int32, L)
        gain = arr("split_gain", np.float32, max(L - 1, 1))
        iv = arr("internal_value", np.float32, max(L - 1, 1))
        icn = arr("internal_count", np.int32, max(L - 1, 1))
        stype = (dt & 1).astype(np.int32)
        dleft = ((dt >> 1) & 1).astype(bool)
        # 0 none / 1 zero / 2 nan — drives the raw-traversal missing routing
        mtypes_all.append(((dt >> 2) & 3).astype(np.int32))

        bitset = np.zeros((max(L - 1, 1), bw), np.uint32)
        if int(fields.get("num_cat", 0)) > 0:
            try:
                bounds = np.array(fields["cat_boundaries"].split(),
                                  dtype=np.int64)
                words = np.array(fields["cat_threshold"].split(),
                                 dtype=np.uint64)
            except (KeyError, ValueError):
                raise ValueError(
                    f"corrupt LightGBM model string: tree {tree_idx} "
                    "declares num_cat>0 but its cat_boundaries/"
                    "cat_threshold are missing or non-numeric") from None
            ci = 0
            for i in range(ns):
                if stype[i]:
                    if ci + 1 >= len(bounds):
                        raise ValueError(
                            f"corrupt LightGBM model string: tree "
                            f"{tree_idx} has more categorical nodes than "
                            "cat_boundaries entries")
                    w = words[bounds[ci]: bounds[ci + 1]]
                    bitset[i, : len(w)] = w.astype(np.uint32)
                    ci += 1
                    thr[i] = 0.0

        trees.append(TreeArrays(
            split_feature=sf, split_bin=np.zeros_like(sf), split_gain=gain,
            split_type=stype, default_left=dleft, cat_bitset=bitset,
            left_child=lc, right_child=rc,
            internal_value=iv, internal_count=icn, leaf_value=lv, leaf_weight=lw,
            leaf_count=lcn, num_splits=np.int32(ns)))

    # synthesize a mapper (loaded models predict from raw values only); the
    # parsed real-valued thresholds ride along as explicit overrides
    mapper = BinMapper(boundaries=np.full((nfeat, 254), np.inf, np.float32),
                       num_bins=np.full(nfeat, 255, np.int32),
                       is_categorical=np.zeros(nfeat, bool), max_bin=255)
    thresholds = _collect_thr(parsed, max_leaves)
    return Booster(mapper, cfg, trees, [1.0] * len(trees),
                   np.zeros(max(num_class, 1)),
                   feature_names if feature_names else None,
                   thresholds=thresholds, missing_types=mtypes_all,
                   device=device)


def _collect_thr(parsed, L):
    out = []
    for fields in parsed:
        size = max(L - 1, 1)
        if "threshold" in fields and fields["threshold"]:
            a = np.array(fields["threshold"].split(), dtype=np.float64)
        else:
            a = np.zeros(size)
        pad = np.zeros(size)
        pad[: min(len(a), size)] = a[:size]
        out.append(pad.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# JSON dump (LightGBMBooster.dumpModel parity — LightGBMBooster.scala:458-516)
# ---------------------------------------------------------------------------

def _tree_to_json(index: int, tree: TreeArrays, thresholds, weight: float,
                  shrinkage: float, base_shift: float = 0.0,
                  missing_types=None) -> dict:
    ns = int(tree.num_splits)
    sf = np.asarray(tree.split_feature)[:ns]
    stype = np.asarray(tree.split_type)[:ns]
    dleft = np.asarray(tree.default_left)[:ns]
    thr = np.asarray(thresholds)[:ns].astype(np.float64)
    lc = np.asarray(tree.left_child)[:ns]
    rc = np.asarray(tree.right_child)[:ns]
    # same base-score fold as the text serializer: LightGBM models carry no
    # separate base score, so a dump consumer summing leaves must see it
    lv = (np.asarray(tree.leaf_value).astype(np.float64) * weight + base_shift)
    lw = np.asarray(tree.leaf_weight).astype(np.float64)
    lcnt = np.asarray(tree.leaf_count)
    gain = np.asarray(tree.split_gain).astype(np.float64)
    iv = np.asarray(tree.internal_value).astype(np.float64)
    icnt = np.asarray(tree.internal_count)
    bits = np.asarray(tree.cat_bitset)[:ns]
    mt = (np.asarray(missing_types, np.int64)[:ns]
          if missing_types is not None and len(sf)
          else np.zeros(len(sf), np.int64))

    # dangling internal pointers (num_splits < num_leaves-1) clamp to leaf 0,
    # exactly like the text serializer's fix_child
    def fix_child(c):
        return int(c) if (c < 0 or c < ns) else ~0

    def leaf_node(leaf: int) -> dict:
        return {"leaf_index": int(leaf), "leaf_value": float(lv[leaf]),
                "leaf_weight": float(lw[leaf]), "leaf_count": int(lcnt[leaf])}

    def internal_node(i: int) -> dict:
        cat = bool(stype[i] == 1)
        if cat:
            # LightGBM JSON encodes the left-going category set as "a||b||c"
            cats = [str(b) for b in range(bits.shape[1] * 32)
                    if (int(bits[i][b >> 5]) >> (b & 31)) & 1]
            threshold = "||".join(cats)
        else:
            threshold = float(thr[i])
        return {
            "split_index": int(i),
            "split_feature": int(sf[i]),
            "split_gain": float(gain[i]),
            "threshold": threshold,
            "decision_type": "==" if cat else "<=",
            "default_left": bool(dleft[i]),
            "missing_type": {0: "None", 1: "Zero", 2: "NaN"}.get(
                int(mt[i]), "None"),
            "internal_value": float(iv[i]),
            "internal_weight": float(max(int(icnt[i]), 1)),
            "internal_count": int(icnt[i]),
        }

    if ns == 0:
        structure = leaf_node(0)
    else:
        # iterative build (deep skewed trees exceed Python's recursion limit)
        structure = internal_node(0)
        stack = [(structure, "left_child", fix_child(lc[0])),
                 (structure, "right_child", fix_child(rc[0]))]
        while stack:
            parent, slot, child = stack.pop()
            if child < 0:
                parent[slot] = leaf_node(~child)
            else:
                nd = internal_node(child)
                parent[slot] = nd
                stack.append((nd, "left_child", fix_child(lc[child])))
                stack.append((nd, "right_child", fix_child(rc[child])))

    return {"tree_index": index,
            "num_leaves": max(ns + 1, 1),
            "num_cat": int((stype == 1).sum()),
            "shrinkage": float(shrinkage),
            "tree_structure": structure}


def booster_dump_json(booster, num_iteration: int = -1) -> str:
    """LightGBM-format JSON model dump (``dumpModel`` parity): the same
    recursive ``tree_structure`` layout lightgbm's own dump_model emits,
    including the base-score fold and "a||b" categorical thresholds. For rf
    boosting, leaves are UNscaled and ``average_output`` is true — the
    consumer averages, as with native dumps."""
    import json

    cfg = booster.config
    mapper = booster.mapper
    k = booster.models_per_iter
    tree_info = [
        _tree_to_json(i, t, thr, w, cfg.learning_rate, base_shift,
                      booster._missing_types(i))
        for i, t, thr, w, base_shift in _tree_dump_seq(booster, num_iteration)]
    doc = {
        "name": "tree",
        "version": "v3",
        "num_class": booster.num_class if k > 1 else 1,
        "num_tree_per_iteration": k,
        "label_index": 0,
        "max_feature_idx": (mapper.num_features - 1) if mapper else 0,
        "objective": _objective_string(cfg),
        "average_output": bool(booster.average_output),
        "feature_names": list(booster.feature_names),
        "monotone_constraints": list(cfg.monotone_constraints or []),
        "tree_info": tree_info,
    }
    return json.dumps(doc)
