"""Host-side image decode, resize and normalize.

Counterpart of the host part of the JAX package's ``ops/image.py``
(``decode_image_bytes``, ``decode_image_files``, ``normalize``,
``to_chw``) and of the vision estimator's ``_resize_host``, which calls
``jax.image.resize(..., "bilinear")``; here that resize is numpy, and its
weight matrices (``linear_weight_matrix``, ``cubic_weight_matrix``) and
nearest indices also serve the ONNX ``Resize`` op on the device. PIL is
imported where a decode runs, as in the JAX package.

``resize_bilinear`` is ``jax.image.resize``'s ``"bilinear"`` method with
its default ``antialias=True``: per resized axis, one weight matrix of the
triangle kernel at half-pixel centres, widened by the scale when
downsampling (the antialias), each output's weights renormalised to sum to
1 and zeroed for a sample outside the input, all in float32
(``compute_weight_mat`` in ``jax/_src/image/scale.py``), then contracted
with the image axis by axis.
"""

from __future__ import annotations

import io
from typing import Optional, Sequence

import numpy as np

_F32_EPS = float(np.finfo(np.float32).eps)


def decode_image_bytes(data: bytes, size: Optional[int] = None) -> np.ndarray:
    """JPEG/PNG bytes → HWC uint8 RGB (PIL bilinear resize to ``size``)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    if size:
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def decode_image_files(paths: Sequence[str],
                       size: Optional[int] = None) -> np.ndarray:
    imgs = []
    for p in paths:
        with open(p, "rb") as f:
            imgs.append(decode_image_bytes(f.read(), size))
    if size is None:
        shapes = {im.shape for im in imgs}
        if len(shapes) > 1:
            raise ValueError(f"images have mixed shapes {shapes}; pass a "
                             "resize size")
    return np.stack(imgs)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel (a = -0.5), as ``jax.image``'s."""
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x
                   + f32(2.0), out)
    return np.where(x >= 2.0, f32(0.0), out).astype(f32)


def _weight_matrix(input_size: int, output_size: int, kernel) -> np.ndarray:
    f32 = np.float32
    inv_scale = f32(1.0 / (output_size / input_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(output_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(input_size, dtype=f32)[:, None]) / kernel_scale
    weights = kernel(x)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * _F32_EPS,
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def linear_weight_matrix(input_size: int, output_size: int) -> np.ndarray:
    """``(input_size, output_size)`` float32 weights of the antialiased
    triangle kernel (jax's ``compute_weight_mat`` with translation 0)."""
    return _weight_matrix(input_size, output_size, _triangle)


def cubic_weight_matrix(input_size: int, output_size: int) -> np.ndarray:
    """The same for Keys' cubic kernel (``jax.image.resize``'s
    ``"cubic"``)."""
    return _weight_matrix(input_size, output_size, _keys_cubic)


def nearest_indices(input_size: int, output_size: int) -> np.ndarray:
    """``jax.image.resize``'s ``"nearest"`` source index of each output
    position: ``floor((i + 0.5) * in / out)`` in float32."""
    offsets = ((np.arange(output_size, dtype=np.float32) + np.float32(0.5))
               * np.float32(input_size) / np.float32(output_size))
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def resize_bilinear(img: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.image.resize(img, shape, "bilinear")`` in float32 numpy: every
    axis whose size changes is resized."""
    out = np.asarray(img, np.float32)
    if len(shape) != out.ndim:
        raise ValueError(f"shape {tuple(shape)} must have one size per axis "
                         f"of the image {out.shape}")
    for axis, (m, n) in enumerate(zip(out.shape, shape)):
        if m != n:
            w = linear_weight_matrix(m, n)
            out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])),
                              -1, axis)
    return np.ascontiguousarray(out, np.float32)


def normalize(images: np.ndarray, mean, std, scale: float = 1.0
              ) -> np.ndarray:
    """Per-channel normalize of NHWC images after a global scale, in the
    images' float type: ``(images * scale - mean) / std``."""
    images = np.asarray(images)
    dt = images.dtype.type
    mean = np.asarray(mean, images.dtype)
    std = np.asarray(std, images.dtype)
    return (images * dt(scale) - mean[None, None, None, :]) \
        / std[None, None, None, :]


def to_chw(images: np.ndarray) -> np.ndarray:
    """NHWC → NCHW."""
    return np.ascontiguousarray(np.transpose(images, (0, 3, 1, 2)))
