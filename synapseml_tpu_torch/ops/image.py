"""Image decode, resize and the OpenCV-style image ops.

Counterpart of the JAX package's ``ops/image.py``. Host part:
``decode_image_bytes``, ``decode_image_files``, ``normalize``, ``to_chw``
and the vision estimator's ``_resize_host``, which calls
``jax.image.resize(..., "bilinear")``; here that resize is numpy
(``resize_bilinear``), and its weight matrices (``linear_weight_matrix``,
``cubic_weight_matrix``) and nearest indices also serve the ONNX
``Resize`` op on the device. PIL is imported where a decode runs, as in
the JAX package.

Device part (the JAX package's jitted ops, ``ImageTransformer.scala``'s
stages): ``resize`` by method name, ``crop``, ``center_crop``, ``flip``,
``gaussian_kernel``, ``blur``, ``threshold`` and ``color_to_gray``, on
NHWC float32 tensors on whatever device they lie on.

``resize`` has ``jax.image.resize``'s semantics (its default
``antialias=True``): ``"nearest"`` takes ``floor((i + 0.5) * in / out)``
per resized axis; every other method builds, per resized axis, one weight
matrix of its kernel at half-pixel centres, widened by the scale when
downsampling (the antialias), each output's weights renormalised to sum to
1 and zeroed for a sample outside the input, all in float32
(``compute_weight_mat`` in ``jax/_src/image/scale.py``), then contracts it
with the image axis by axis. An axis whose size does not change is left
alone, as there.
"""

from __future__ import annotations

import io
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device

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


def _lanczos(radius: int):
    """``jax.image``'s Lanczos kernel of ``radius`` lobes, in float32."""
    f32 = np.float32
    pi = f32(np.pi)

    def kernel(x: np.ndarray) -> np.ndarray:
        y = f32(radius) * np.sin(pi * x) * np.sin(pi * x / f32(radius))
        den = np.where(x != 0, f32(np.pi ** 2) * (x * x), f32(1.0))
        out = np.where(x > f32(1e-3), y / den, f32(1.0))
        return np.where(x > f32(radius), f32(0.0), out).astype(f32)
    return kernel


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


# --------------------------------------------------------------------------
# device ops (NHWC float32 tensors; the JAX package's jitted ops)
# --------------------------------------------------------------------------

# jax.image.resize's method names → the weight kernel (None: nearest)
_RESIZE_KERNELS = {
    "nearest": None,
    "linear": _triangle, "bilinear": _triangle, "trilinear": _triangle,
    "triangle": _triangle,
    "cubic": _keys_cubic, "bicubic": _keys_cubic, "tricubic": _keys_cubic,
    "lanczos3": _lanczos(3), "lanczos5": _lanczos(5),
}


def resize(images: torch.Tensor, height: int, width: int,
           method: str = "bilinear") -> torch.Tensor:
    """ResizeImage (``ImageTransformer.scala:88-118``): NHWC ``images`` to
    ``(N, height, width, C)`` by ``jax.image.resize``'s ``method``
    (module docstring), on the images' device."""
    if method not in _RESIZE_KERNELS:
        raise ValueError(f"unknown resize method {method!r}; expected one "
                         f"of {sorted(_RESIZE_KERNELS)}")
    kernel = _RESIZE_KERNELS[method]
    out = images
    for axis, size in ((1, int(height)), (2, int(width))):
        m = int(out.shape[axis])
        if m == size:
            continue
        if kernel is None:
            idx = torch.from_numpy(nearest_indices(m, size)).to(out.device)
            out = out.index_select(axis, idx)
            continue
        w = torch.from_numpy(_weight_matrix(m, size, kernel)).to(
            device=out.device, dtype=out.dtype)
        out = (torch.einsum("nhwc,hy->nywc", out, w) if axis == 1
               else torch.einsum("nhwc,wy->nhyc", out, w))
    return out.contiguous()


def crop(images: torch.Tensor, x: int, y: int, height: int,
         width: int) -> torch.Tensor:
    """CropImage (``:120-149``): the ``height`` x ``width`` rectangle at
    ``(x, y)``. As ``lax.dynamic_slice``, a start that would run past the
    image is clamped so that the rectangle fits."""
    h, w = int(images.shape[1]), int(images.shape[2])
    y0 = min(max(int(y), 0), h - int(height))
    x0 = min(max(int(x), 0), w - int(width))
    if y0 < 0 or x0 < 0:
        raise ValueError(f"crop of {height}x{width} does not fit a {h}x{w} "
                         "image")
    return images[:, y0:y0 + int(height), x0:x0 + int(width)]


def center_crop(images: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    """CenterCropImage (``:151-180``)."""
    h, w = int(images.shape[1]), int(images.shape[2])
    y = max((h - height) // 2, 0)
    x = max((w - width) // 2, 0)
    return crop(images, x, y, min(height, h), min(width, w))


def flip(images: torch.Tensor, flip_code: int = 1) -> torch.Tensor:
    """Flip (``:216-235``). OpenCV codes: 0 vertical, > 0 horizontal,
    < 0 both."""
    if flip_code == 0:
        return images.flip(1)
    if flip_code > 0:
        return images.flip(2)
    return images.flip(1, 2)


def gaussian_kernel(aperture: int, sigma: float,
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """GaussianKernel (``:260-283``): the normalised ``aperture`` x
    ``aperture`` float32 kernel on ``device``."""
    r = np.float32((aperture - 1) / 2.0)
    xs = torch.arange(aperture, dtype=torch.float32,
                      device=resolve_device(device)) - float(r)
    k1 = torch.exp(-(xs * xs) / float(np.float32(2 * sigma ** 2)))
    k = torch.outer(k1, k1)
    return k / k.sum()


def blur(images: torch.Tensor, ksize: int = 3,
         sigma: float = 1.0) -> torch.Tensor:
    """Blur (``:182-199``): a depthwise convolution of every channel with
    ``gaussian_kernel(ksize, sigma)``, zero-padded to the input's size
    (XLA's SAME: the smaller half of the padding before)."""
    c = int(images.shape[-1])
    k = gaussian_kernel(ksize, sigma, images.device).to(images.dtype)
    weight = k[None, None].expand(c, 1, ksize, ksize)
    lo = (ksize - 1) // 2
    hi = ksize - 1 - lo
    x = torch.nn.functional.pad(images.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    out = torch.nn.functional.conv2d(x, weight, groups=c)
    return out.permute(0, 2, 3, 1).contiguous()


def threshold(images: torch.Tensor, thresh: float,
              maxval: float = 1.0) -> torch.Tensor:
    """Threshold (``:237-258``), THRESH_BINARY: ``maxval`` where a value
    exceeds ``thresh``, else 0."""
    hi = torch.tensor(maxval, dtype=images.dtype, device=images.device)
    return torch.where(images > thresh, hi, torch.zeros_like(hi))


def color_to_gray(images: torch.Tensor) -> torch.Tensor:
    """ColorFormat(GRAY) (``:201-214``): ITU-R 601 luma, ``(N, H, W, 1)``."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=images.dtype,
                     device=images.device)
    return (images * w).sum(-1, keepdim=True)
