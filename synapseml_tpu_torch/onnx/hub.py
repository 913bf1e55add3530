"""ONNXHub — model-zoo manifest client with a local cache.

The port's own copy of the JAX package's ``onnx/hub.py``; both read the same
cache directory.

Reference: deep-learning/.../onnx/ONNXHub.scala (downloads models from the
onnx/models GitHub manifest, verifies sha256, caches locally). This
environment has no network egress, so downloads are gated: the manifest and
models resolve from the local cache dir (``SYNAPSEML_TPU_ONNX_HUB`` or
``~/.synapseml_tpu/onnx_hub``); a missing entry raises with instructions
rather than attempting a fetch. The API shape (list_models / get_model_info /
load) matches the reference so code written against it ports over.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

_DEFAULT_REPO = "onnx/models:main"


def _cache_dir() -> str:
    return os.environ.get(
        "SYNAPSEML_TPU_ONNX_HUB",
        os.path.join(os.path.expanduser("~"), ".synapseml_tpu", "onnx_hub"))


@dataclass
class ONNXModelInfo:
    model: str
    model_path: str
    opset: int
    metadata: Dict


class ONNXHub:
    """Manifest-driven model registry (reference ONNXHub.scala)."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir or _cache_dir()

    def _manifest_path(self) -> str:
        return os.path.join(self.cache_dir, "ONNX_HUB_MANIFEST.json")

    def get_manifest(self) -> List[ONNXModelInfo]:
        path = self._manifest_path()
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"ONNX hub manifest not found at {path}. This environment has "
                "no network egress; place ONNX_HUB_MANIFEST.json (from the "
                "onnx/models repo) and the model files under "
                f"{self.cache_dir} to use the hub.")
        with open(path) as f:
            raw = json.load(f)
        return [ONNXModelInfo(m["model"], m["model_path"],
                              m.get("opset_version", 0), m.get("metadata", {}))
                for m in raw]

    def list_models(self, model: Optional[str] = None,
                    tags: Optional[List[str]] = None) -> List[ONNXModelInfo]:
        infos = self.get_manifest()
        if model:
            infos = [i for i in infos if model.lower() in i.model.lower()]
        if tags:
            tset = {t.lower() for t in tags}
            infos = [i for i in infos
                     if tset & {str(t).lower()
                                for t in i.metadata.get("tags", [])}]
        return infos

    def get_model_info(self, model: str,
                       opset: Optional[int] = None) -> ONNXModelInfo:
        matches = [i for i in self.get_manifest()
                   if i.model.lower() == model.lower()]
        if not matches:
            raise KeyError(f"model {model!r} not in manifest")
        if opset is not None:
            matches = [i for i in matches if i.opset == opset]
            if not matches:
                raise KeyError(f"model {model!r} has no opset {opset}")
        return max(matches, key=lambda i: i.opset)

    def load(self, model: str, opset: Optional[int] = None) -> bytes:
        info = self.get_model_info(model, opset)
        path = os.path.join(self.cache_dir, info.model_path)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"model file {path} missing from the local hub cache "
                "(no network egress to download it)")
        with open(path, "rb") as f:
            data = f.read()
        want = info.metadata.get("model_sha")
        if want:
            got = hashlib.sha256(data).hexdigest()
            if got != want:
                raise ValueError(f"sha256 mismatch for {model}: {got} != {want}")
        return data

    getModelInfo = get_model_info
    listModels = list_models
