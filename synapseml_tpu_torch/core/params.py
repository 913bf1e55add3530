"""Typed, metadata-rich parameter system.

A copy of the JAX package's ``core/params.py`` (the port imports nothing of that
package). The analog of SparkML ``Params`` plus SynapseML's ``ComplexParam``
extensions (reference: core/src/main/scala/com/microsoft/azure/synapse/ml/core/serialize/
ComplexParam.scala and core/.../param/*.scala). Every stage declares its parameters
declaratively as class attributes; the metaclass collects them, generates camelCase
getter/setters (``getFeaturesCol``/``setFeaturesCol``) for API parity with the
reference's auto-generated wrappers (reference: core/.../codegen/Wrappable.scala), and
the same metadata drives JSON serialization, ``explainParams``, and copy semantics.

Unlike the reference — where params live in Scala and Python wrappers are generated —
this framework is Python-native, so the param metadata is the single source of truth.
"""

from __future__ import annotations

import copy as _copy
import json
from typing import Any, Callable, Optional


class Param:
    """A single declared parameter: name, doc, type, default, validator.

    ``dtype`` is advisory (used for coercion and docs); ``validator`` raises or
    returns a possibly-coerced value. ``is_complex`` marks values that cannot be
    JSON-serialized (models, callables, arrays) — the analog of the reference's
    ComplexParam; such values are serialized by the owning stage's save path.
    """

    __slots__ = ("name", "doc", "dtype", "default", "validator", "is_complex", "_owner")

    def __init__(
        self,
        name: str,
        doc: str = "",
        dtype: Optional[type] = None,
        default: Any = None,
        validator: Optional[Callable[[Any], Any]] = None,
        is_complex: bool = False,
    ):
        self.name = name
        self.doc = doc
        self.dtype = dtype
        self.default = default
        self.validator = validator
        self.is_complex = is_complex
        self._owner = None

    # descriptor protocol: `stage.featuresCol` reads the current value
    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.get(self.name)

    def __set__(self, obj, value):
        obj.set(self.name, value)

    def __repr__(self):
        return f"Param({self.name!r}, default={self.default!r})"

    def coerce(self, value: Any) -> Any:
        if value is None:
            return value
        if self.validator is not None:
            out = self.validator(value)
            if out is not None:
                value = out
        if self.dtype is not None and not self.is_complex:
            if self.dtype is float and isinstance(value, int) and not isinstance(value, bool):
                value = float(value)
            elif self.dtype is int and isinstance(value, float) and value.is_integer():
                value = int(value)
            elif not isinstance(value, self.dtype):
                # allow duck-typed sequences for list/tuple-typed params
                if self.dtype in (list, tuple) and hasattr(value, "__iter__") and not isinstance(value, (str, bytes)):
                    value = self.dtype(value)
                else:
                    raise TypeError(
                        f"Param {self.name}: expected {self.dtype.__name__}, "
                        f"got {type(value).__name__} ({value!r})"
                    )
        return value


def _make_getter(name):
    def getter(self):
        return self.get(name)

    getter.__name__ = "get" + name[0].upper() + name[1:]
    getter.__doc__ = f"Get the value of ``{name}``."
    return getter


def _make_setter(name):
    def setter(self, value):
        return self.set(name, value)

    setter.__name__ = "set" + name[0].upper() + name[1:]
    setter.__doc__ = f"Set ``{name}`` and return self (fluent)."
    return setter


class _ParamsMeta(type):
    """Collects Param class attributes (including inherited) and generates
    ``getX``/``setX`` fluent accessors, mirroring the reference's generated API."""

    def __new__(mcls, clsname, bases, ns):
        cls = super().__new__(mcls, clsname, bases, ns)
        params: dict[str, Param] = {}
        for base in reversed(cls.__mro__):
            for key, val in vars(base).items():
                if isinstance(val, Param):
                    params[val.name] = val
        cls._params = params
        for pname in params:
            cap = pname[0].upper() + pname[1:]
            if "get" + cap not in ns and not hasattr(cls, "get" + cap):
                setattr(cls, "get" + cap, _make_getter(pname))
            if "set" + cap not in ns and not hasattr(cls, "set" + cap):
                setattr(cls, "set" + cap, _make_setter(pname))
        return cls


class Params(metaclass=_ParamsMeta):
    """Base for anything with declared parameters.

    Constructor accepts any declared param as a keyword argument::

        est = LightGBMClassifier(numIterations=100, learningRate=0.1)

    Values live in ``self._paramMap`` (explicitly set) with fall-through to
    declared defaults, matching SparkML paramMap/defaultParamMap semantics.
    """

    _params: dict[str, Param] = {}

    def __init__(self, **kwargs):
        self._paramMap: dict[str, Any] = {}
        for k, v in kwargs.items():
            if k not in self._params:
                raise ValueError(
                    f"{type(self).__name__} has no param {k!r}. "
                    f"Available: {sorted(self._params)}"
                )
            self.set(k, v)

    # --- core accessors -------------------------------------------------
    def set(self, name: str, value: Any) -> "Params":
        p = self._params[name]
        self._paramMap[name] = p.coerce(value)
        return self

    def get(self, name: str, default: Any = None) -> Any:
        if name in self._paramMap:
            return self._paramMap[name]
        p = self._params.get(name)
        if p is not None and p.default is not None:
            d = p.default
            # mutable defaults are shared class-level objects: hand out a
            # copy so user mutation can't silently rewrite every instance
            return (list(d) if isinstance(d, list)
                    else dict(d) if isinstance(d, dict) else d)
        if p is None:
            raise KeyError(f"{type(self).__name__} has no param {name!r}")
        return p.default if default is None else default

    def isSet(self, name: str) -> bool:
        return name in self._paramMap

    def hasParam(self, name: str) -> bool:
        return name in self._params

    def setParams(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self.set(k, v)
        return self

    def copy(self, extra: Optional[dict] = None) -> "Params":
        out = _copy.copy(self)
        out._paramMap = dict(self._paramMap)
        if extra:
            for k, v in extra.items():
                out.set(k, v)
        return out

    # --- introspection --------------------------------------------------
    def explainParams(self) -> str:
        lines = []
        for name in sorted(self._params):
            p = self._params[name]
            cur = self._paramMap.get(name, "undefined")
            lines.append(f"{name}: {p.doc} (default: {p.default!r}, current: {cur!r})")
        return "\n".join(lines)

    def extractParamMap(self) -> dict:
        out = {n: p.default for n, p in self._params.items() if p.default is not None}
        out.update(self._paramMap)
        return out

    # --- serialization --------------------------------------------------
    def _simple_params_json(self) -> dict:
        """Explicitly-set, JSON-able params (complex ones handled by save paths)."""
        out = {}
        for k, v in self._paramMap.items():
            if self._params[k].is_complex:
                continue
            try:
                json.dumps(v)
                out[k] = v
            except (TypeError, ValueError):
                pass
        return out

    def __repr__(self):
        set_params = ", ".join(f"{k}={v!r}" for k, v in sorted(self._paramMap.items())
                               if not self._params[k].is_complex)
        return f"{type(self).__name__}({set_params})"


# ---------------------------------------------------------------------------
# Shared column-param mixins (reference: core/.../core/contracts/Params.scala —
# HasFeaturesCol/HasLabelCol/HasOutputCol/... traits used across every module)
# ---------------------------------------------------------------------------

class HasFeaturesCol(Params):
    featuresCol = Param("featuresCol", "The name of the features column", str, "features")


class HasLabelCol(Params):
    labelCol = Param("labelCol", "The name of the label column", str, "label")


class HasInputCol(Params):
    inputCol = Param("inputCol", "The name of the input column", str, "input")


class HasOutputCol(Params):
    outputCol = Param("outputCol", "The name of the output column", str, "output")


class HasInputCols(Params):
    inputCols = Param("inputCols", "The names of the input columns", list)


class HasOutputCols(Params):
    outputCols = Param("outputCols", "The names of the output columns", list)


class HasPredictionCol(Params):
    predictionCol = Param("predictionCol", "The name of the prediction column", str, "prediction")


class HasRawPredictionCol(Params):
    rawPredictionCol = Param("rawPredictionCol", "Raw prediction (margin) column name", str, "rawPrediction")


class HasProbabilityCol(Params):
    probabilityCol = Param("probabilityCol", "Predicted class probabilities column name", str, "probability")


class HasWeightCol(Params):
    weightCol = Param("weightCol", "The name of the instance-weight column", str)


class HasValidationIndicatorCol(Params):
    validationIndicatorCol = Param(
        "validationIndicatorCol",
        "Boolean column: true rows are used for validation, false for training", str)


class HasInitScoreCol(Params):
    initScoreCol = Param("initScoreCol", "Column with per-row initial scores (margin warm start)", str)


class HasGroupCol(Params):
    groupCol = Param("groupCol", "Column with the query/group id for ranking", str)


class HasSeed(Params):
    seed = Param("seed", "Random seed", int, 0)
