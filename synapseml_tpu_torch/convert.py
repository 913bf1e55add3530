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

The vision backbones (``dl.backbones.ResNet``, ``TinyCNN``) keep flax's
names and layouts too (convolution kernels HWIO), with the BatchNorm
running statistics as buffers: ``resnet_from_reference`` turns flax's
``{"params": ..., "batch_stats": ...}`` variables into the ``state_dict``,
``resnet_to_reference`` turns it back, nested or as one flat dict keyed by
``"params/<path>"`` and ``"batch_stats/<path>"`` (the vision model's
``params.npz`` of earlier versions). The round trip is bitwise.
``staged_from_reference`` and ``staged_to_reference`` do the same for a
staged model (``dl.StageSequential``: ``stages_k/units_j/...``, batch
statistics included).

``trainer_state_from_reference`` carries the JAX trainer's whole state
across: the parameters and batch statistics as a ``state_dict`` and the
optax optimizer state as its flax state dict of numpy arrays, which
``dl.trainer.Trainer.load_params(..., opt_state=...)`` loads (the port's
``Optimizer.state_dict`` keeps optax's layout).

``vw_state_arrays`` reads a VW learner state off either package's
``VWState`` as its seven fields (``weights``, ``acc``, ``bias``,
``bias_acc``, ``t``, ``loss_sum``, ``weight_sum``: float32 numpy arrays, the
scalars 0-d) and ``vw_state_from_reference`` builds this package's
``VWState`` from them on a device. Both packages' ``VWState.to_bytes`` write
the same npz layout, so a snapshot either one saved through
``save_to_store`` loads in the other.
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


def _flatten(tree, prefix: str = "", out: Optional[dict] = None) -> dict:
    """A nested dict of arrays as one dict keyed by '/'-joined paths."""
    out = {} if out is None else out
    for name, value in tree.items():
        if isinstance(value, Mapping):
            _flatten(value, f"{prefix}{name}/", out)
        else:
            out[prefix + name] = value
    return out


def _nest(flat: dict) -> dict:
    """The reverse of ``_flatten``."""
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _to_tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A float32 copy (``.numpy()`` of a CPU tensor would share its memory,
    and a training step updates the tensor in place)."""
    return t.detach().float().cpu().numpy().copy()


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
    return {path.replace("/", "."): _to_tensor(value)
            for path, value in _flatten(params).items()}


def text_encoder_to_reference(state_dict, nested: bool = True) -> dict:
    """The reverse of ``text_encoder_from_reference``: a ``state_dict`` (or
    ``named_parameters``) of the text modules as the flax parameter tree,
    nested dicts of float32 numpy arrays without the ``"params"`` level;
    with ``nested=False`` one flat dict keyed by '/'-joined flax paths."""
    flat = {name.replace(".", "/"): _to_numpy(t)
            for name, t in dict(state_dict).items()}
    return _nest(flat) if nested else flat


BATCH_STATS_LEAVES = ("mean", "var")


def resnet_from_reference(variables) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of this package's vision backbone from the JAX
    package's flax variables of the same configuration: ``{"params":
    tree, "batch_stats": tree}`` (``batch_stats`` absent for ``TinyCNN``),
    or the flat ``"params/..."``/``"batch_stats/..."`` dict of a saved
    ``params.npz``. Load it with ``module.load_state_dict(sd)``."""
    flat = _flatten(variables)
    unknown = sorted({k.split("/", 1)[0] for k in flat}
                     - {"params", "batch_stats"})
    if unknown:
        raise ValueError(f"flax variables hold collections {unknown}; "
                         "expected 'params' and 'batch_stats'")
    return {path.split("/", 1)[1].replace("/", "."): _to_tensor(value)
            for path, value in flat.items()}


def resnet_to_reference(state_dict, nested: bool = True) -> dict:
    """The reverse of ``resnet_from_reference``: flax's ``{"params": ...,
    "batch_stats": ...}`` of float32 numpy arrays (BatchNorm's ``mean`` and
    ``var`` buffers under ``batch_stats``); with ``nested=False`` one flat
    dict keyed by ``"params/<path>"`` and ``"batch_stats/<path>"``."""
    flat = {}
    for name, t in dict(state_dict).items():
        leaf = name.rsplit(".", 1)[-1]
        coll = "batch_stats" if leaf in BATCH_STATS_LEAVES else "params"
        flat[f"{coll}/{name.replace('.', '/')}"] = _to_numpy(t)
    return _nest(flat) if nested else flat


def staged_from_reference(variables) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of this package's ``dl.StageSequential`` from the
    JAX package's flax variables of the same staging
    (``make_staged_backbone``, ``staged_text_encoder``): ``{"params":
    {"stages_k": {"units_j": ...}}, "batch_stats": ...}`` (``batch_stats``
    absent without BatchNorm), or the flat ``"params/..."`` dict. Load it
    with ``model.load_state_dict(sd)``."""
    sd = resnet_from_reference(variables)
    bad = sorted({k.split(".", 1)[0] for k in sd
                  if not k.startswith("stages_")})
    if bad:
        raise ValueError(f"staged variables hold {bad} beside stages_k")
    return sd


def staged_to_reference(state_dict, nested: bool = True) -> dict:
    """The reverse of ``staged_from_reference``: flax's ``{"params": ...,
    "batch_stats": ...}`` of a ``StageSequential``'s ``state_dict`` (no
    ``batch_stats`` level without BatchNorm buffers), nested or flat."""
    out = resnet_to_reference(state_dict, nested)
    if nested:
        out.setdefault("params", {})
    return out


def _numpy_leaves(tree):
    if isinstance(tree, Mapping):
        return {k: _numpy_leaves(v) for k, v in tree.items()}
    return np.array(tree)


def trainer_state_from_reference(params, batch_stats=None, opt_state=None
                                 ) -> Tuple[Dict[str, torch.Tensor],
                                            Optional[dict]]:
    """``(state_dict, opt_state)`` for ``Trainer.load_params`` from the JAX
    trainer's ``params``, ``batch_stats`` and optax ``opt_state`` (leaves
    anything ``np.array`` reads): the optimizer state becomes flax's state
    dict of its tree (tuples and optax's namedtuples as dicts), numpy
    leaves; None without one."""
    from .core.serialization import to_state_dict

    sd = resnet_from_reference({"params": params,
                                "batch_stats": batch_stats or {}})
    opt = None if opt_state is None else \
        _numpy_leaves(to_state_dict(opt_state))
    return sd, opt


def vw_state_arrays(state) -> Dict[str, np.ndarray]:
    """The seven fields of either package's ``VWState`` as float32 numpy
    arrays (it only reads attributes)."""
    from .vw.learner import VWState

    out = {}
    for k in VWState._FIELDS:
        v = getattr(state, k)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v, np.float32)
    return out


def vw_state_from_reference(arrays: Dict[str, np.ndarray],
                            device=DEFAULT_DEVICE):
    """This package's ``VWState`` on ``device`` from ``vw_state_arrays``'s
    fields (e.g. of a JAX-trained state)."""
    from .vw.learner import VWState

    return VWState.from_arrays(arrays, device)
