"""DeepVisionClassifier / DeepVisionModel: vision fine-tuning estimators.

Counterpart of the JAX package's ``dl/vision.py``: a backbone of
``dl.backbones`` (ResNet-18/34/50/101 or ``tiny``) trained by
``dl.trainer.Trainer`` on ``device`` (default ``"cuda"``; a missing card
raises), with the JAX package's params, image handling, shuffled
validation holdout and layer freezing. ``additionalLayersToTrain``: the
head always trains, that many trailing backbone blocks besides, -1 trains
everything.

Images (``_resolve_images``, as the JAX package's): a 4-D numeric column,
an object column of HWC arrays, or a column of file paths (decoded by PIL).
``imageSize`` resizes on the host with ``ops.image.resize_bilinear`` (the
JAX package's ``jax.image.resize(..., "bilinear")``). As there, uint8
images are scaled to [0, 1] only when no resize turned them into float32
first; 3-channel images are then normalised with ImageNet's mean and std.

Checkpoints: ``save`` writes ``params.msgpack`` as the JAX package does
(flax's msgpack of ``{"params", "batch_stats"}``, float32, keys sorted as
a fitted flax tree's: byte for byte the JAX estimator's file for the same
weights, through ``core.serialization``), ``classes.npy`` and
``arch.json``; ``load`` reads a directory either package saved, and the
``params.npz`` (``"params/<path>"``, ``"batch_stats/<path>"``) of earlier
versions of this package. ``pretrainedPath`` takes a flax ``.msgpack`` or
such an ``.npz``.
"""

from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Optional

import numpy as np
import torch

from ..core import Estimator, HasLabelCol, HasPredictionCol, Model, Param, Table
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..ops.image import decode_image_files, resize_bilinear
from .backbones import make_backbone
from .trainer import TrainConfig, Trainer, softmax_np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _resolve_images(col, image_size: Optional[int]) -> np.ndarray:
    """Column → (N, H, W, C) float32. Accepts a 4-D numeric array column,
    an object column of HWC arrays, or a column of file paths."""
    arr = np.asarray(col)
    if arr.dtype == object:
        first = arr[0]
        if isinstance(first, (str, bytes)):
            arr = decode_image_files(list(arr), image_size)
        else:
            imgs = [np.asarray(a) for a in arr]
            if image_size:
                imgs = [_resize_host(im, image_size) for im in imgs]
            elif len({im.shape for im in imgs}) > 1:
                raise ValueError(
                    "image column contains arrays of differing shapes; set "
                    "imageSize to resize them to a common size")
            arr = np.stack(imgs)
    elif image_size and arr.ndim >= 3 and arr.shape[1] != image_size:
        # every image at once: the per-image resize, axis by axis
        arr = resize_bilinear(arr, (len(arr), image_size, image_size)
                              + arr.shape[3:])
    if arr.ndim == 3:
        arr = arr[..., None]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return np.ascontiguousarray(arr, np.float32)


def _resize_host(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of one HWC (or HW) image to ``size`` x ``size``,
    float32; an image already that size is returned as it is."""
    if img.shape[:2] == (size, size):
        return img
    return resize_bilinear(img, (size, size) + img.shape[2:])


def _normalize(images: np.ndarray) -> np.ndarray:
    if images.shape[-1] == 3:
        return (images - IMAGENET_MEAN) / IMAGENET_STD
    return images


def _check_precision(precision: str) -> torch.dtype:
    if precision not in _DTYPES:
        raise ValueError(f"precision must be float32 or bfloat16, got "
                         f"{precision!r}")
    return _DTYPES[precision]


def _load_checkpoint(path: str) -> dict:
    """The ``state_dict`` (parameters and batch statistics) of flax
    variables in a msgpack file or an ``.npz``."""
    from ..convert import resnet_from_reference
    from ..core.serialization import msgpack_restore

    if zipfile.is_zipfile(path):
        with np.load(path) as f:
            return resnet_from_reference({k: f[k] for k in f.files})
    with open(path, "rb") as f:
        return resnet_from_reference(msgpack_restore(f.read()))


class DeepVisionClassifier(Estimator, HasLabelCol, HasPredictionCol):
    backbone = Param("backbone", "Backbone name (resnet18/34/50/101, tiny)", str, "resnet50")
    additionalLayersToTrain = Param(
        "additionalLayersToTrain",
        "Number of trailing backbone blocks to unfreeze besides the head (-1 = all)",
        int, 2)
    batchSize = Param("batchSize", "Training batch size", int, 16)
    maxEpochs = Param("maxEpochs", "Training epochs", int, 1)
    learningRate = Param("learningRate", "Learning rate", float, 1e-3)
    optimizer = Param("optimizer", "adam/adamw/sgd/momentum", str, "adam")
    imageCol = Param("imageCol", "Input image column", str, "image")
    imageSize = Param("imageSize", "Resize target (square); 0 = as-is", int, 0)
    dropoutAUX = Param("dropoutAUX", "compat no-op (torchvision aux dropout)", float, 0.01)
    storePrefixPath = Param("storePrefixPath", "compat no-op (horovod store)", str)
    precision = Param("precision", "float32 or bfloat16 compute", str, "float32")
    seed = Param("seed", "Random seed", int, 0)
    pretrainedPath = Param("pretrainedPath", "Local .msgpack/.npz checkpoint "
                           "of flax variables (params, batch_stats)", str)
    validationFraction = Param("validationFraction", "Holdout fraction for val metrics", float, 0.0)
    smallImages = Param("smallImages", "CIFAR-style stem (3x3 conv, no max-pool)", bool, False)
    device = Param("device", "Device that trains and scores the model: "
                   "'cuda' (default) or 'cpu'", str, DEFAULT_DEVICE)

    def _fit(self, df: Table) -> "DeepVisionModel":
        resolve_device(self.getDevice())
        dtype = _check_precision(self.getPrecision())
        images = _resolve_images(df[self.getImageCol()],
                                 self.getImageSize() or None)
        labels_raw = np.asarray(df[self.getLabelCol()])
        classes, y = np.unique(labels_raw, return_inverse=True)
        model = make_backbone(self.getBackbone(), len(classes), dtype=dtype,
                              small_images=self.getSmallImages(),
                              in_channels=images.shape[-1])
        X = _normalize(images)

        cfg = TrainConfig(batch_size=self.getBatchSize(),
                          max_epochs=self.getMaxEpochs(),
                          learning_rate=self.getLearningRate(),
                          optimizer=self.getOptimizer(),
                          freeze_regex=self._freeze_regex(model),
                          compute_dtype=self.getPrecision(),
                          seed=self.getSeed())
        trainer = Trainer(model, cfg, device=self.getDevice())
        trainer.init(X[:1])
        if self.get("pretrainedPath"):
            trainer.load_params(_load_checkpoint(self.get("pretrainedPath")))

        valid = None
        vf = self.getValidationFraction()
        if vf > 0:
            # shuffled holdout: a sorted input table must not yield a
            # single-class validation split
            perm = np.random.default_rng(self.getSeed()).permutation(len(X))
            nv = max(int(len(X) * vf), 1)
            valid = (X[perm[:nv]], y[perm[:nv]])
            X, y = X[perm[nv:]], y[perm[nv:]]
        trainer.fit(X, y, valid=valid,
                    log_fn=lambda ep: self._log_base("epoch", ep))

        m = DeepVisionModel(trainer=trainer, classes=classes)
        for p in ("backbone", "smallImages", "precision", "device"):
            m.set(p, self.get(p))
        m._input_shape = list(X.shape[1:])
        for p in ("imageCol", "predictionCol", "imageSize"):
            if self.isSet(p):
                m.set(p, self.get(p))
        return m

    def _freeze_regex(self, model) -> Optional[str]:
        """The JAX package's regex over the model's top-level children: all
        but the head and the trailing ``additionalLayersToTrain`` blocks
        (None: train everything). Names in flax's key order (sorted), so
        the string is the JAX package's."""
        k = self.getAdditionalLayersToTrain()
        if k < 0:
            return None
        top = sorted(name for name, _ in model.named_children())

        def _block_order(name):
            m = re.search(r"(\d+)$", name)
            return int(m.group(1)) if m else -1

        blocks = sorted([t for t in top if "Block" in t], key=_block_order)
        if not blocks or k >= len(blocks):
            return None   # blockless backbone, or every block unfrozen
        trainable = set(blocks[len(blocks) - k:] if k else [])
        trainable.add("head")
        frozen = [t for t in top if t not in trainable]
        if not frozen:
            return None
        return r"^(" + "|".join(frozen) + r")/"


class DeepVisionModel(Model, HasPredictionCol):
    imageCol = Param("imageCol", "Input image column", str, "image")
    imageSize = Param("imageSize", "Resize target (square); 0 = as-is", int, 0)
    backbone = Param("backbone", "Backbone name (for reload)", str, "resnet50")
    smallImages = Param("smallImages", "CIFAR-style stem", bool, False)
    precision = Param("precision", "float32 or bfloat16 compute", str, "float32")
    device = Param("device", "Device that scores the model: 'cuda' "
                   "(default) or 'cpu'", str, DEFAULT_DEVICE)

    # class-level defaults: instances materialized by PipelineStage.load
    # bypass __init__
    trainer: Optional[Trainer] = None
    classes: Optional[np.ndarray] = None
    _input_shape: Optional[list] = None

    def __init__(self, trainer: Optional[Trainer] = None,
                 classes: Optional[np.ndarray] = None, **kwargs):
        super().__init__(**kwargs)
        self.trainer = trainer
        self.classes = classes
        self._input_shape = None

    def _transform(self, df: Table) -> Table:
        X = _normalize(_resolve_images(df[self.getImageCol()],
                                       self.getImageSize() or None))
        logits = self.trainer.predict_logits(X)
        pred = (self.classes[logits.argmax(-1)] if self.classes is not None
                else logits.argmax(-1))
        if np.issubdtype(np.asarray(pred).dtype, np.number):
            pred = np.asarray(pred, np.float64)
        out = df.with_column(self.getPredictionCol(), pred)
        return out.with_column("probability", softmax_np(logits))

    def _save_extra(self, path: str) -> None:
        from ..convert import resnet_to_reference
        from ..core.serialization import to_bytes
        from .trainer import nest_sorted

        flat = resnet_to_reference(self.trainer.model.state_dict(),
                                   nested=False)
        variables = {c: nest_sorted({k.split("/", 1)[1]: v
                                     for k, v in flat.items()
                                     if k.startswith(c + "/")})
                     for c in ("params", "batch_stats")}
        with open(os.path.join(path, "params.msgpack"), "wb") as f:
            f.write(to_bytes(variables))
        np.save(os.path.join(path, "classes.npy"), self.classes)
        with open(os.path.join(path, "arch.json"), "w") as f:
            json.dump({"input_shape": self._input_shape}, f)

    def _load_extra(self, path: str) -> None:
        params = os.path.join(path, "params.msgpack")
        if not os.path.exists(params):
            params = os.path.join(path, "params.npz")
        self.classes = np.load(os.path.join(path, "classes.npy"),
                               allow_pickle=True)
        with open(os.path.join(path, "arch.json")) as f:
            self._input_shape = json.load(f)["input_shape"]
        model = make_backbone(self.getBackbone(), len(self.classes),
                              dtype=_check_precision(self.getPrecision()),
                              small_images=self.getSmallImages(),
                              in_channels=self._input_shape[-1])
        trainer = Trainer(model, TrainConfig(
            compute_dtype=self.getPrecision()), device=self.getDevice())
        self.trainer = trainer.load_params(_load_checkpoint(params))
