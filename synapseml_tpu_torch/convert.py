"""Carry a trained booster across packages as plain numpy arrays.

The JAX package's ``Booster`` and this package's hold the same fields, so a
forest trained by one can be scored and saved by the other. The exchange
format is a flat ``{name: np.ndarray}`` dict plus a ``BoosterConfig`` dict:

* the ``BinMapper`` fields ``boundaries``, ``num_bins``, ``is_categorical``,
  ``max_bin``, ``has_nan``, ``cat_counts``;
* every ``TreeArrays`` field, stacked over trees on a leading axis
  (``split_feature`` is ``(T, L-1)``, ``leaf_value`` is ``(T, L)``, ...);
* ``tree_weights`` ``(T,)`` and ``init_score`` (the booster's base score,
  one per class: a K-class booster holds K trees per iteration in
  iteration-major order, tree ``it * K + c`` of class ``c``);
* optionally ``thresholds`` and ``missing_types`` ``(T, L-1)``, which a
  booster loaded from a model string carries in place of a bin mapper.

The config carries the objective and its parameters (``num_class``,
``sigmoid``, ``alpha``, ``fair_c``, ``poisson_max_delta_step``,
``tweedie_variance_power``, lambdarank's ``label_gain`` and truncation), so
a multiclass, regression or ranking booster scores and saves the same.
``booster_arrays`` reads that format off either package's ``Booster`` (it
only reads attributes, so it needs neither package's framework), and
``booster_from_reference`` builds this package's ``Booster`` from it.

The text modules (``dl.text.TransformerEncoder`` and the units of
``dl.backbones``) keep flax's parameter names and layouts, so
``text_encoder_from_reference`` turns a flax parameter tree of the JAX
package's modules into this package's ``state_dict`` by flattening it, and
``text_encoder_to_reference`` turns a ``state_dict`` back into the flax
tree (nested dicts of numpy arrays), or into one flat dict keyed by the
'/'-joined flax paths (the text model's saved format).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.device import DEFAULT_DEVICE
from .gbdt.boosting import Booster, BoosterConfig
from .gbdt.grower import TreeArrays
from .ops.quantize import BinMapper

_MAPPER_FIELDS = ("boundaries", "num_bins", "is_categorical", "max_bin",
                  "has_nan", "cat_counts")


def booster_arrays(booster) -> Tuple[Dict[str, np.ndarray], dict]:
    """(arrays, config dict) of a trained ``Booster`` of either package."""
    arrays = {f: np.asarray(getattr(booster.mapper, f))
              for f in _MAPPER_FIELDS if getattr(booster.mapper, f) is not None}
    for f in TreeArrays._fields:
        arrays[f] = np.stack([np.asarray(getattr(t, f)) for t in booster.trees])
    arrays["tree_weights"] = np.asarray(booster.tree_weights, np.float64)
    arrays["init_score"] = np.asarray(booster.base_score, np.float64)
    for f in ("thresholds", "missing_types"):
        if getattr(booster, f) is not None:
            arrays[f] = np.stack([np.asarray(a) for a in getattr(booster, f)])
    names = {f.name for f in dataclasses.fields(BoosterConfig)}
    config = {k: v for k, v in vars(booster.config).items() if k in names}
    return arrays, config


def booster_from_reference(arrays: Dict[str, np.ndarray], config: dict,
                           feature_names: Optional[List[str]] = None,
                           device=DEFAULT_DEVICE) -> Booster:
    """This package's ``Booster`` (scoring on ``device``) from the arrays
    and ``BoosterConfig`` fields of a booster trained elsewhere."""
    mapper = BinMapper(
        boundaries=np.asarray(arrays["boundaries"], np.float32),
        num_bins=np.asarray(arrays["num_bins"], np.int32),
        is_categorical=np.asarray(arrays["is_categorical"], bool),
        max_bin=int(arrays["max_bin"]),
        has_nan=(np.asarray(arrays["has_nan"], bool)
                 if "has_nan" in arrays else None),
        cat_counts=(np.asarray(arrays["cat_counts"], np.int32)
                    if "cat_counts" in arrays else None))
    names = {f.name for f in dataclasses.fields(BoosterConfig)}
    unknown = sorted(set(config) - names)
    if unknown:
        raise ValueError(f"config has fields BoosterConfig lacks: {unknown}")
    cfg = BoosterConfig(**config)
    num_trees = len(arrays["split_feature"])
    trees = [TreeArrays(**{f: np.asarray(arrays[f][i])
                           for f in TreeArrays._fields})
             for i in range(num_trees)]
    per_tree = {f: (list(np.asarray(arrays[f])) if f in arrays else None)
                for f in ("thresholds", "missing_types")}
    return Booster(mapper, cfg, trees,
                   [float(w) for w in np.asarray(arrays["tree_weights"])],
                   np.asarray(arrays["init_score"], np.float64),
                   feature_names, thresholds=per_tree["thresholds"],
                   missing_types=per_tree["missing_types"], device=device)


def text_encoder_from_reference(params) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of this package's ``TransformerEncoder`` from the
    JAX package's flax parameters of the same configuration: the nested
    dict of arrays that ``model.init`` returns (with or without its
    ``"params"`` level), path components joined with ``"."``; a flat dict
    keyed by '/'-joined paths is taken too. The same serves
    ``TransformerLayerUnit``, ``TextEmbedUnit`` and ``TextClsHead``. Load it
    with ``module.load_state_dict(sd)``, which checks every name and
    shape."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
            else:
                out[(prefix + name).replace("/", ".")] = torch.from_numpy(
                    np.array(value, dtype=np.float32))

    walk(params, "")
    return out


def text_encoder_to_reference(state_dict, nested: bool = True) -> dict:
    """The reverse of ``text_encoder_from_reference``: a ``state_dict`` (or
    ``named_parameters``) of the text modules as the flax parameter tree,
    nested dicts of float32 numpy arrays without the ``"params"`` level;
    with ``nested=False`` one flat dict keyed by '/'-joined flax paths."""
    flat = {name.replace(".", "/"): t.detach().float().cpu().numpy()
            for name, t in dict(state_dict).items()}
    if not nested:
        return flat
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree
