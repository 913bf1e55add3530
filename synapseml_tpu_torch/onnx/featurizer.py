"""ImageFeaturizer — headless CNN features from images.

The port's counterpart of the JAX package's ``onnx/featurizer.py``
(reference ImageFeaturizer: ONNX model + image preprocessing;
``headless=True`` fetches the layer before the classifier). Host
preprocessing (``ops/image.py``: ``jax.image.resize``'s bilinear resize,
normalize, NHWC → NCHW) feeds an ``ONNXModel``, which scores on its own
``device``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.params import Param, HasInputCol, HasOutputCol
from ..core.pipeline import Transformer
from ..core.table import Table
from .model import ONNXModel


class ImageFeaturizer(Transformer, HasInputCol, HasOutputCol):
    headless = Param("headless", "fetch the penultimate (feature) tensor "
                     "instead of the final output", bool, True)
    onnxModel = Param("onnxModel", "the ONNXModel to run", is_complex=True)
    featureTensorName = Param("featureTensorName", "intermediate tensor to "
                              "fetch when headless (defaults to the input of "
                              "the last MatMul/Gemm node)", str)
    imageHeight = Param("imageHeight", "resize height", int, 224)
    imageWidth = Param("imageWidth", "resize width", int, 224)
    channelNormalizationMeans = Param("channelNormalizationMeans",
                                      "per-channel means", list,
                                      [0.485, 0.456, 0.406])
    channelNormalizationStds = Param("channelNormalizationStds",
                                     "per-channel stds", list,
                                     [0.229, 0.224, 0.225])
    scaleFactor = Param("scaleFactor", "pixel scale before normalize", float,
                        1.0 / 255.0)

    # the configured (sliced) model, so repeated transforms reuse the parsed
    # graph and its captured runners
    _cfg_cache: Optional[tuple] = None

    def setModel(self, model: ONNXModel) -> "ImageFeaturizer":
        self._cfg_cache = None
        return self.set("onnxModel", model)

    def _configured_model(self, base: ONNXModel, fn, input_name: str) -> ONNXModel:
        # key holds `base` itself (not id()) — keeping the reference alive
        # prevents CPython id reuse from serving a stale sliced model
        key = (base, self.getHeadless(),
               self.get("featureTensorName"), self.getOutputCol())
        if (self._cfg_cache is not None and self._cfg_cache[0][0] is base
                and self._cfg_cache[0][1:] == key[1:]):
            return self._cfg_cache[1]
        model = base.copy()
        if self.getHeadless():
            model.setFetchDict({self.getOutputCol(): self._headless_output(base)})
        else:
            model.setFetchDict({self.getOutputCol(): fn.outputs[0]})
        model.set("softMaxDict", None)
        model.set("argMaxDict", None)
        model.setFeedDict({input_name: "__image_tensor"})
        self._cfg_cache = (key, model)
        return model

    def setModelPayload(self, payload: bytes) -> "ImageFeaturizer":
        return self.set("onnxModel", ONNXModel(modelPayload=payload))

    def _headless_output(self, base: ONNXModel) -> str:
        if self.isSet("featureTensorName"):
            return self.getFeatureTensorName()
        # default: the (non-weight) input of the last MatMul/Gemm — the
        # penultimate representation in classifier CNNs
        fn = base._onnx_fn()
        g = fn.model.graph
        inits = set(g.initializers)
        for node in reversed(g.nodes):
            if node.op_type in ("Gemm", "MatMul"):
                for i in node.inputs:
                    if i and i not in inits:
                        return i
        raise ValueError(
            "could not infer a feature tensor (no MatMul/Gemm head); set "
            "featureTensorName explicitly")

    def _transform(self, df: Table) -> Table:
        from ..ops import image as I

        base: Optional[ONNXModel] = self.get("onnxModel")
        if base is None:
            raise ValueError("ImageFeaturizer: onnxModel is not set")
        fn = base._onnx_fn()
        input_name = fn.graph_inputs[0]

        imgs = df[self.getInputCol()]
        if imgs.dtype == object:
            imgs = np.stack([np.asarray(v, dtype=np.float32) for v in imgs])
        imgs = np.asarray(imgs, np.float32)
        n, _, _, c = imgs.shape
        batch = I.resize_bilinear(imgs, (n, self.getImageHeight(),
                                         self.getImageWidth(), c))
        batch = I.normalize(batch, self.getChannelNormalizationMeans(),
                            self.getChannelNormalizationStds(),
                            scale=self.getScaleFactor())
        batch = I.to_chw(batch)

        model = self._configured_model(base, fn, input_name)

        work = df.with_column("__image_tensor",
                              np.asarray(batch, dtype=np.float32))
        out = model.transform(work)
        del out["__image_tensor"]
        feat = out[self.getOutputCol()]
        if feat.ndim > 2:  # flatten CNN feature maps to vectors
            out[self.getOutputCol()] = feat.reshape(feat.shape[0], -1)
        return out
