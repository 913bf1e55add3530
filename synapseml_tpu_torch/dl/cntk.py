"""CNTKModel — deprecated API-compat stub (VERDICT r4 coverage row 36).

Reference: deep-learning/src/main/python/synapse/ml/cntk/CNTKModel.py — kept
there purely for backwards compatibility; CNTK itself has been archived and
the reference's own docs steer users to ONNXModel. This stub preserves the
API shape for migrating code: a model file that parses as ONNX bytes (the
common case — CNTK's exporter and every conversion path emit ONNX) delegates
to the port's :class:`~synapseml_tpu_torch.onnx.model.ONNXModel` on
``device`` (default the card); a native CNTK-v2 ``.model`` protobuf raises
with conversion guidance instead of failing obscurely.

The port's copy of the JAX package's ``dl/cntk.py``, with one param more:
``device``, handed to the ``ONNXModel``. The delegate is kept between
transforms while the file and the params it was built from stay the same,
so its imported graph and captured batches are reused (the JAX module
parses the file again on every transform).
"""

from __future__ import annotations

import os

from ..core.device import DEFAULT_DEVICE
from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.table import Table
from ..onnx.model import ONNXModel
from ..onnx.protoio import Model as ProtoModel


class CNTKModel(Transformer):
    """Deprecated: use :class:`ONNXModel`. Compatibility shim only."""

    modelLocation = Param("modelLocation", "path to the model file", str)
    inputCol = Param("inputCol", "input column", str, "input")
    outputCol = Param("outputCol", "output column", str, "output")
    miniBatchSize = Param("miniBatchSize", "batch size for inference", int,
                          64)
    device = Param("device", "Device that scores the model: 'cuda' "
                   "(default) or 'cpu'", str, DEFAULT_DEVICE)

    def setModelLocation(self, path: str) -> "CNTKModel":
        return self.set("modelLocation", path)

    def setInputCol(self, v: str) -> "CNTKModel":
        return self.set("inputCol", v)

    def setOutputCol(self, v: str) -> "CNTKModel":
        return self.set("outputCol", v)

    def setMiniBatchSize(self, v: int) -> "CNTKModel":
        return self.set("miniBatchSize", v)

    # (file identity and params, ONNXModel) of the last delegate built; a
    # class-level default, as stages made by load or copy skip __init__
    _delegate_cache = None

    def _delegate(self) -> ONNXModel:
        path = self.get("modelLocation")
        if not path:
            raise ValueError("CNTKModel: modelLocation is not set")
        st = os.stat(path)
        key = (os.path.abspath(path), st.st_mtime_ns, st.st_size,
               self.get("inputCol"), self.get("outputCol"),
               self.get("miniBatchSize"), self.get("device"))
        if self._delegate_cache is not None \
                and self._delegate_cache[0] == key:
            return self._delegate_cache[1]
        with open(path, "rb") as f:
            raw = f.read()
        try:
            m = ProtoModel.parse(raw)
            ok = bool(m.graph.nodes) or bool(m.graph.initializers)
        except Exception:
            ok = False
        if not ok:
            raise NotImplementedError(
                "CNTKModel is a deprecated compatibility shim: native "
                "CNTK-v2 .model files are not executable here (CNTK is "
                "archived upstream). Export the model to ONNX "
                "(cntk.Function.save(..., format=ModelFormat.ONNX)) and "
                "load it with ONNXModel / CNTKModel.setModelLocation "
                "pointing at the .onnx file.")
        # declaration order, matching ONNXModel's own feed convention — a
        # sorted() pick could map inputCol onto an aux input like a mask
        fn_inputs = [vi.name for vi in m.graph.inputs
                     if vi.name not in m.graph.initializers]
        if not fn_inputs or not m.graph.outputs:
            raise ValueError("CNTKModel: model has no graph inputs/outputs")
        model = (ONNXModel()
                 .setModelPayload(raw)
                 .set("feedDict", {fn_inputs[0]: self.get("inputCol")})
                 .set("fetchDict", {self.get("outputCol"):
                                    m.graph.outputs[0].name})
                 .set("miniBatchSize", self.get("miniBatchSize"))
                 .set("device", self.get("device")))
        self._delegate_cache = (key, model)
        return model

    def _transform(self, df: Table) -> Table:
        # _transform (not transform): the base wrapper adds the stage's own
        # telemetry span and Table coercion like every other Transformer
        import warnings

        warnings.warn("CNTKModel is deprecated; use ONNXModel "
                      "(the reference keeps it for API compatibility only)",
                      DeprecationWarning, stacklevel=2)
        return self._delegate().transform(df)
