"""ONNX inference — protobuf reader, importer, batch transformer, hub,
featurizer.

The port's counterpart of the JAX package's ``onnx`` package. ONNX protobufs
are parsed directly (``protoio.py`` — no onnx package needed), imported into
functions of torch tensors (``importer.py`` + the ``ops.py`` registry of 135
ops) and scored mini-batched through the bucketed runner's captured CUDA
graphs (``model.py``). ``booster_to_onnx`` writes a trained GBDT booster as
an ``ai.onnx.ml`` TreeEnsemble graph.
"""

from .protoio import Attribute, Graph, Model, Node, Tensor, ValueInfo
from .importer import OnnxFunction, fold_constants, import_model
from .model import ONNXModel
from .hub import ONNXHub, ONNXModelInfo
from .featurizer import ImageFeaturizer
from .ops import REGISTRY as OP_REGISTRY

__all__ = [
    "Attribute", "Graph", "Model", "Node", "Tensor", "ValueInfo",
    "OnnxFunction", "fold_constants", "import_model",
    "ONNXModel", "ONNXHub", "ONNXModelInfo", "ImageFeaturizer",
    "OP_REGISTRY", "booster_to_onnx",
]


def __getattr__(name):
    # lazy, as in the JAX package: the tree-ensemble writer pulls the gbdt
    # package
    if name == "booster_to_onnx":
        from .treeensemble import booster_to_onnx

        return booster_to_onnx
    raise AttributeError(name)
