"""Host-side image decode and resize.

Counterpart of the host part of the JAX package's ``ops/image.py``
(``decode_image_bytes``, ``decode_image_files``) and of the vision
estimator's ``_resize_host``, which calls ``jax.image.resize(...,
"bilinear")``; here that resize is numpy. PIL is imported where a decode
runs, as in the JAX package.

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


def linear_weight_matrix(input_size: int, output_size: int) -> np.ndarray:
    """``(input_size, output_size)`` float32 weights of the antialiased
    triangle kernel (jax's ``compute_weight_mat`` with translation 0)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (output_size / input_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(output_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(input_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * _F32_EPS,
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


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
