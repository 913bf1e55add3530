"""ONNXModel — batch inference Transformer over an imported ONNX graph.

The port's counterpart of the JAX package's ``onnx/model.py``. Parity
points: ``modelPayload`` bytes param; ``feedDict`` (onnx input ← table
column) and ``fetchDict`` (output column ← onnx output, including
*intermediate* tensors — model slicing); mini-batched execution
(``miniBatchSize``); ``softMaxDict``/``argMaxDict`` post-transforms. The graph
is imported once (``importer.OnnxFunction``) on ``device`` (default
``"cuda"``; a missing card raises) and scored through the port's
``BucketedRunner``, one runner per (inputs, outputs, batch size): on the card
each batch bucket is one captured CUDA graph, replayed per batch, and a
graph that cannot be captured raises (nothing runs eagerly in its place).
``deviceType`` stays an accepted param for the API; where the model runs is
``device``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.table import Table
from .importer import OnnxFunction, fold_constants, loop_bound_error
from .protoio import DTYPES, Model as ProtoModel


class ONNXModel(Transformer):
    modelPayload = Param("modelPayload", "Array of bytes containing the "
                         "serialized ONNX model", is_complex=True)
    feedDict = Param("feedDict", "map: ONNX input name -> table column",
                     is_complex=True)
    fetchDict = Param("fetchDict", "map: output column -> ONNX output name "
                      "(intermediate tensor names allowed)", is_complex=True)
    miniBatchSize = Param("miniBatchSize", "batch size for inference", int, 64)
    softMaxDict = Param("softMaxDict", "map: input col -> output col to "
                        "softmax", is_complex=True)
    argMaxDict = Param("argMaxDict", "map: input col -> output col to argmax",
                       is_complex=True)
    deviceType = Param("deviceType", "kept for API parity (CPU/CUDA in the "
                       "reference); the model runs on `device`", str)
    optimizationLevel = Param("optimizationLevel", "kept for API parity",
                              str, "ALL_OPT")
    floatPrecision = Param("floatPrecision", "float32 | bfloat16 — bfloat16 "
                           "runs products as bf16 operands with float32 "
                           "accumulation", str, "float32")
    maxLoopTrips = Param("maxLoopTrips", "iteration bound of runtime ONNX "
                         "Loop nodes whose trip count is data-dependent "
                         "(scan outputs are zero-padded past the exit)",
                         int, 128)
    device = Param("device", "Device that scores the model: 'cuda' "
                   "(default) or 'cpu'", str, DEFAULT_DEVICE)

    # class-level defaults so instances materialized by save/load or copy
    # (which bypass __init__) still lazy-init their caches
    _fn_cache: Optional[OnnxFunction] = None
    _runner_cache: Optional[dict] = None

    # --- model loading -----------------------------------------------------
    def setModelPayload(self, payload: bytes) -> "ONNXModel":
        self._fn_cache = None
        self._runner_cache = {}
        return self.set("modelPayload", payload)

    def setModelLocation(self, path: str) -> "ONNXModel":
        with open(path, "rb") as f:
            return self.setModelPayload(f.read())

    def setFeedDict(self, d: Dict[str, str]) -> "ONNXModel":
        return self.set("feedDict", dict(d))

    def setFetchDict(self, d: Dict[str, str]) -> "ONNXModel":
        self._fn_cache = None
        return self.set("fetchDict", dict(d))

    def setSoftMaxDict(self, d: Dict[str, str]) -> "ONNXModel":
        return self.set("softMaxDict", dict(d))

    def setArgMaxDict(self, d: Dict[str, str]) -> "ONNXModel":
        return self.set("argMaxDict", dict(d))

    def setMiniBatchSize(self, v: int) -> "ONNXModel":
        return self.set("miniBatchSize", v)

    # --- introspection -----------------------------------------------------
    def _onnx_fn(self) -> OnnxFunction:
        # rebuild when floatPrecision or device changed through ANY setter
        # route (the cached function holds its weights in both)
        dev = resolve_device(self.getDevice())
        if self._fn_cache is not None and (
                self._fn_cache.precision != self.getFloatPrecision()
                or self._fn_cache.device != dev):
            self._fn_cache = None
            self._runner_cache = None
        if self._fn_cache is None:
            payload = self.get("modelPayload")
            if payload is None:
                raise ValueError("ONNXModel: modelPayload is not set")
            model = fold_constants(ProtoModel.parse(bytes(payload)))
            fetch = self.get("fetchDict") or {}
            outputs = sorted(fetch.values()) if fetch else None
            self._fn_cache = OnnxFunction(
                model, outputs, precision=self.getFloatPrecision(),
                max_loop_trips=self.get("maxLoopTrips"), device=dev)
        return self._fn_cache

    def modelInput(self) -> Dict[str, dict]:
        fn = self._onnx_fn()
        return {n: {"shape": fn.input_info[n].shape if n in fn.input_info else None,
                    "dtype": np.dtype(DTYPES.get(
                        fn.input_info[n].elem_type, np.float32)).name
                    if n in fn.input_info else "float32"}
                for n in fn.graph_inputs}

    def modelOutput(self) -> List[str]:
        return list(self._onnx_fn().outputs)

    # --- execution ---------------------------------------------------------
    def _transform(self, df: Table) -> Table:
        fn = self._onnx_fn()
        feed: Dict[str, str] = self.get("feedDict") or {
            n: n for n in fn.graph_inputs}
        fetch: Dict[str, str] = self.get("fetchDict") or {
            o: o for o in fn.outputs}
        out_of = {onnx_name: col for col, onnx_name in fetch.items()}

        # dtype coercion per declared graph input
        cols: Dict[str, np.ndarray] = {}
        for onnx_name, col in feed.items():
            arr = df[col]
            if arr.dtype == object:
                arr = np.stack([np.asarray(v) for v in arr])
            vi = fn.input_info.get(onnx_name)
            want = DTYPES.get(vi.elem_type, np.float32) if vi else np.float32
            cols[onnx_name] = np.asarray(arr).astype(want, copy=False)

        n = df.num_rows
        bs = min(self.getMiniBatchSize(), max(n, 1))
        names = list(cols)

        out = df.copy()
        if n == 0:
            for o in fn.outputs:
                out[out_of.get(o, o)] = np.zeros((0,))
            return self._post_transforms(out)

        # full miniBatchSize chunks plus a tail padded to the runner's
        # bucket ladder (padded rows repeat the last row and are sliced off)
        runner = self._runner_for(fn, names, bs)
        *res, cut = runner(*[cols[m] for m in names])
        if np.any(cut):
            raise loop_bound_error(fn.max_loop_trips)
        for o, r in zip(fn.outputs, res):
            out[out_of.get(o, o)] = np.asarray(r)
        return self._post_transforms(out)

    def _runner_for(self, fn: OnnxFunction, names: List[str],
                    batch_size: int):
        from ..core.inference import BucketedRunner

        if self._runner_cache is None:
            self._runner_cache = {}
        key = (tuple(names), tuple(fn.outputs), batch_size)
        if key not in self._runner_cache:
            self._runner_cache[key] = BucketedRunner(
                fn._runner_fn(names), max_batch_size=batch_size,
                name="onnx.model", device=fn.device)
        return self._runner_cache[key]

    def _post_transforms(self, df: Table) -> Table:
        for kind, mapping in (("softMaxDict", self.get("softMaxDict")),
                              ("argMaxDict", self.get("argMaxDict"))):
            for src, dst in (mapping or {}).items():
                if src not in df:
                    raise ValueError(
                        f"ONNXModel.{kind}: source column {src!r} not in the "
                        f"transformed output (columns: {df.columns}); update "
                        "the dict when changing fetchDict")
                if kind == "softMaxDict":
                    df = df.with_column(dst, torch.softmax(torch.from_numpy(
                        np.asarray(df[src], np.float32)), dim=-1).numpy())
                else:
                    df = df.with_column(dst, np.argmax(
                        np.asarray(df[src]), axis=-1).astype(np.float64))
        return df

    # persistence: the payload is a complex param, nothing extra needed
    def sliceAtOutput(self, output_name: str) -> "ONNXModel":
        """New ONNXModel fetching an intermediate tensor (headless-model
        helper)."""
        sliced = self.copy()
        sliced.setFetchDict({output_name: output_name})
        sliced.set("softMaxDict", None)  # post-ops referenced the old outputs
        sliced.set("argMaxDict", None)
        return sliced
