"""Estimator / Transformer / Pipeline protocol.

A copy of the JAX package's ``core/pipeline.py``. The analog of the SparkML
PipelineStage hierarchy the reference builds on
(every SynapseML component is an Estimator or Transformer; reference layer L2,
SURVEY.md §1). ``fit`` consumes a Table and returns a fitted Model (a Transformer);
``transform`` consumes and produces Tables. Save/load writes a directory with a JSON
metadata file plus any complex artifacts the stage contributes — the analog of
ComplexParamsWritable (reference: core/.../core/serialize/ComplexParamsSerializer.scala).
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
from typing import List, Optional

import numpy as np

from .logging import SynapseMLLogging
from .params import Params
from .table import Table

_META_FILE = "metadata.json"


class PipelineStage(Params, SynapseMLLogging):
    """Base of every stage. Subclasses are constructible from kwargs alone plus
    whatever artifacts they persist via ``_save_extra``/``_load_extra``."""

    # the device ``load`` was asked for (None: each stage's saved param)
    _load_device = None

    def __init__(self, **kwargs):
        Params.__init__(self, **kwargs)
        SynapseMLLogging.__init__(self)
        self.uid = f"{type(self).__name__}_{id(self):x}"
        self.log_class()

    # --- persistence ----------------------------------------------------
    def save(self, path: str, overwrite: bool = True) -> None:
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)
        meta = {
            "class": f"{type(self).__module__}.{type(self).__name__}",
            "uid": self.uid,
            "params": self._simple_params_json(),
            "framework_version": _framework_version(),
        }
        with open(os.path.join(path, _META_FILE), "w") as f:
            json.dump(meta, f, indent=1, default=_json_default)
        self._save_complex_params(path)
        self._save_extra(path)

    @staticmethod
    def load(path: str, device=None) -> "PipelineStage":
        """The stage saved at ``path``. ``device`` (e.g. ``"cpu"``), when
        given, replaces the saved ``device`` param of this stage and of
        every stage nested in it before their models are loaded, so a model
        saved on the card loads on the CPU and the other way round."""
        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
        cls = _stage_class(meta["class"])
        stage = cls.__new__(cls)
        PipelineStage.__init__(stage)
        for k, v in meta["params"].items():
            if stage.hasParam(k):
                stage.set(k, v)
        if device is not None and stage.hasParam("device"):
            stage.set("device", str(device))
        stage.uid = meta.get("uid", stage.uid)
        stage._load_device = device
        stage._load_complex_params(path)
        stage._load_extra(path)
        return stage

    def _save_extra(self, path: str) -> None:  # complex artifacts (weights, trees...)
        pass

    def _load_extra(self, path: str) -> None:
        pass

    # Complex params (callables, stages, arrays) can't go in metadata.json; they
    # are pickled per-param — the analog of ComplexParam's own serialization
    # (reference: core/.../core/serialize/ComplexParam.scala). Values that
    # cannot pickle are skipped with a warning rather than failing the save.
    def _save_complex_params(self, path: str) -> None:
        import warnings

        try:
            import cloudpickle as pickler
        except ImportError:  # pragma: no cover
            import pickle as pickler
        complex_set = {k: v for k, v in self._paramMap.items()
                       if self._params[k].is_complex and v is not None}
        if not complex_set:
            return
        saved = []
        os.makedirs(os.path.join(path, "complexParams"), exist_ok=True)
        for name, value in complex_set.items():
            if isinstance(value, PipelineStage):
                value.save(os.path.join(path, "complexParams", name + ".stage"))
                saved.append([name, "stage"])
                continue
            try:
                blob = pickler.dumps(value)
            except Exception as e:  # noqa: BLE001
                warnings.warn(f"{type(self).__name__}.{name}: not serializable ({e}); "
                              "set it again after load")
                continue
            with open(os.path.join(path, "complexParams", name + ".pkl"), "wb") as f:
                f.write(blob)
            saved.append([name, "pickle"])
        with open(os.path.join(path, "complexParams", "index.json"), "w") as f:
            json.dump(saved, f)

    def _load_complex_params(self, path: str) -> None:
        idx_file = os.path.join(path, "complexParams", "index.json")
        if not os.path.exists(idx_file):
            return
        with open(idx_file) as f:
            saved = json.load(f)
        for name, kind in saved:
            if kind == "stage":
                value = PipelineStage.load(
                    os.path.join(path, "complexParams", name + ".stage"),
                    self._load_device)
            else:
                with open(os.path.join(path, "complexParams", name + ".pkl"), "rb") as f:
                    value = _PortUnpickler(f).load()
            self.set(name, value)


class Transformer(PipelineStage):
    def transform(self, df: Table) -> Table:
        with self.log_verb("transform", rows=df.num_rows if isinstance(df, Table) else None):
            return self._transform(_as_table(df))

    def _transform(self, df: Table) -> Table:
        raise NotImplementedError

    def __call__(self, df: Table) -> Table:
        return self.transform(df)


class Estimator(PipelineStage):
    def fit(self, df: Table, params: Optional[dict] = None) -> "Transformer":
        est = self.copy(params) if params else self
        with self.log_verb("fit", rows=df.num_rows if isinstance(df, Table) else None):
            return est._fit(_as_table(df))

    def _fit(self, df: Table) -> "Transformer":
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""


class Pipeline(Estimator):
    """Sequential stage composition (SparkML Pipeline analog)."""

    def __init__(self, stages: Optional[List[PipelineStage]] = None, **kwargs):
        super().__init__(**kwargs)
        self.stages = list(stages or [])

    def setStages(self, stages) -> "Pipeline":
        self.stages = list(stages)
        return self

    def getStages(self):
        return self.stages

    def _fit(self, df: Table) -> "PipelineModel":
        fitted: List[Transformer] = []
        cur = df
        for stage in self.stages:
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
                cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                cur = stage.transform(cur)
            else:
                raise TypeError(f"not a PipelineStage: {stage!r}")
        return PipelineModel(fitted)

    def _save_extra(self, path: str) -> None:
        _save_stage_list(self.stages, path)

    def _load_extra(self, path: str) -> None:
        self.stages = _load_stage_list(path, self._load_device)


class PipelineModel(Model):
    def __init__(self, stages: Optional[List[Transformer]] = None, **kwargs):
        super().__init__(**kwargs)
        self.stages = list(stages or [])

    def _transform(self, df: Table) -> Table:
        cur = df
        for stage in self.stages:
            cur = stage.transform(cur)
        return cur

    def _save_extra(self, path: str) -> None:
        _save_stage_list(self.stages, path)

    def _load_extra(self, path: str) -> None:
        self.stages = _load_stage_list(path, self._load_device)


# ---------------------------------------------------------------------------

def _save_stage_list(stages, path):
    order = []
    for i, s in enumerate(stages):
        sub = os.path.join(path, f"stage_{i:03d}")
        s.save(sub)
        order.append(os.path.basename(sub))
    with open(os.path.join(path, "stages.json"), "w") as f:
        json.dump(order, f)


def _load_stage_list(path, device=None):
    with open(os.path.join(path, "stages.json")) as f:
        order = json.load(f)
    return [PipelineStage.load(os.path.join(path, name), device)
            for name in order]


def _as_table(df) -> Table:
    if isinstance(df, Table):
        return df
    # accept pandas DataFrames transparently at the API boundary
    if hasattr(df, "columns") and hasattr(df, "to_numpy"):
        return Table.from_pandas(df)
    if isinstance(df, dict):
        return Table(df)
    raise TypeError(f"expected Table / pandas DataFrame / dict of columns, got {type(df)}")


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _framework_version():
    from .. import __version__

    return __version__


# this package's top-level name, and the JAX package's: the same without
# the "_torch" suffix
_PORT_PACKAGE = __name__.split(".")[0]
_JAX_PACKAGE = _PORT_PACKAGE[: -len("_torch")]


class _PortUnpickler(pickle.Unpickler):
    """Unpickles a saved complex param. A pickle the JAX package wrote
    names its classes (a ``BallTree``, say) by that package's module paths;
    they resolve to this package's counterparts, as ``_stage_class`` does
    for ``metadata.json``, so loading never imports the JAX package."""

    def find_class(self, module: str, name: str):
        if module.partition(".")[0] != _JAX_PACKAGE:
            return super().find_class(module, name)
        port = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
        try:
            return getattr(importlib.import_module(port), name)
        except (ImportError, AttributeError) as e:
            raise NotImplementedError(
                f"the saved object {module}.{name} has no counterpart in the "
                f"PyTorch package (looked for {port}.{name})") from e


def _stage_class(name: str):
    """The class a saved ``metadata.json`` names. A directory the JAX
    package saved names its classes by that package's module paths; they
    map to this package's counterparts (the same module path under this
    package) without importing the JAX package, and a class with no
    counterpart raises ``NotImplementedError`` naming it."""
    mod_name, cls_name = name.rsplit(".", 1)
    top, _, rest = mod_name.partition(".")
    if top != _JAX_PACKAGE:
        return getattr(importlib.import_module(mod_name), cls_name)
    port = f"{_PORT_PACKAGE}.{rest}"
    try:
        return getattr(importlib.import_module(port), cls_name)
    except (ImportError, AttributeError) as e:
        raise NotImplementedError(
            f"the saved stage {name} has no counterpart in the PyTorch "
            f"package (looked for {port}.{cls_name})") from e
