"""The flax layers the text encoder and the vision backbones are built
from, in PyTorch.

Each module keeps flax's parameter names and layouts (a dense kernel is
``(in, out)``, the attention projections ``(hidden, heads, head_dim)`` and
``(heads, head_dim, hidden)``), so a flax parameter tree flattened with
``.`` is this package's ``state_dict`` (``convert.text_encoder_from_reference``).
Parameters start from flax's default initialisers' distributions (not
their random numbers).

Numerics kept from flax: ``LayerNorm`` epsilon 1e-6 (torch's default is
1e-5), ``gelu`` in its tanh approximation (flax's ``nn.gelu`` default;
torch's is exact), and the default attention scales the query by
``1/sqrt(head_dim)`` before the product (``dot_product_attention``).

Compute dtype, as flax's ``dtype=`` (``param_dtype`` stays float32):
parameters are float32 and each layer casts its inputs and parameters to
``dtype`` (float32 or bfloat16) and computes in it; ``LayerNorm`` takes its
statistics and normalises in float32 and returns ``dtype``.

Attention dropout, as flax's ``MultiHeadDotProductAttention`` with its
default ``broadcast_dropout=True``: in training, one keep mask of shape
``(1, 1, Sq, Sk)`` (shared across batch and heads) drops attention weights
with probability ``dropout_rate`` and scales the survivors by
``1 / (1 - dropout_rate)``. The mask is drawn from the ``torch.Generator``
the caller passes (flax draws from its ``dropout`` rng stream, so the masks
differ from flax's; only their law is the same).

Vision layers (``Conv``, ``BatchNorm``, ``max_pool``) take and return NHWC
tensors, as flax's do; an NHWC-contiguous tensor permuted to NCHW is
already ``channels_last``, so cuDNN reads it without a copy. What differs
from a plain ``torch.nn`` translation:

* ``"SAME"`` padding is XLA's: per spatial dim ``total = max((ceil(n/s) -
  1)·s + k - n, 0)``, ``lo = total // 2`` before and ``hi = total - lo``
  after. A 3x3 stride-2 window on an even input pads (0, 1), not torch's
  symmetric 1; ``max_pool`` pads with -inf.
* ``Conv`` keeps flax's HWIO kernel ``(kh, kw, in, out)``.
* ``BatchNorm``: epsilon 1e-5; flax's ``momentum=0.9`` keeps 0.9 of the
  running statistics (torch's ``momentum=0.1``), and the running ``var``
  takes the biased batch variance (torch's the unbiased). In training the
  batch's statistics are taken in float32 and the normalisation runs in
  float32 whatever ``dtype`` (the output is ``dtype``). ``scale`` and
  ``bias`` are parameters, ``mean`` and ``var`` buffers (flax's
  ``batch_stats``). Inside ``batch_stats_over(group)`` (the trainer's
  data-parallel steps) the batch is the rows of every rank of ``group``:
  the sum, the sum of squares and the count go through one differentiable
  ``psum`` in float32, and the variance is flax's default
  ``use_fast_variance`` form ``max(E[x²] - E[x]², 0)``; every rank then
  holds the same running statistics, as the JAX package's global batch
  gives.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6
BATCH_NORM_EPS = 1e-5
BATCH_NORM_MOMENTUM = 0.9
_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to +-2
_STATS_GROUP: list = []


@contextlib.contextmanager
def batch_stats_over(group):
    """Training forwards inside the scope take BatchNorm's moments over the
    rows of every rank of the process ``group`` (None: this rank's)."""
    _STATS_GROUP.append(group)
    try:
        yield
    finally:
        _STATS_GROUP.pop()


def lecun_normal_(t: torch.Tensor, fan_in: int) -> None:
    """flax's ``lecun_normal``: truncated normal, variance 1 / fan_in."""
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class DenseGeneral(nn.Module):
    """``y = x · kernel + bias`` contracting the last ``len(in_shape)`` axes
    of x with the first axes of ``kernel`` (``in_shape + out_shape``)."""

    def __init__(self, in_shape: tuple, out_shape: tuple,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self._n_in = len(in_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        lecun_normal_(self.kernel, math.prod(self.kernel.shape[:self._n_in]))
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return (torch.tensordot(x.to(dt), self.kernel.to(dt), dims=self._n_in)
                + self.bias.to(dt))


def Dense(in_features: int, out_features: int,
          dtype: torch.dtype = torch.float32) -> DenseGeneral:
    """flax ``nn.Dense``: kernel ``(in, out)`` and bias ``(out,)``."""
    return DenseGeneral((in_features,), (out_features,), dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: ``scale`` and ``bias``,
    epsilon 1e-6, computed in float32 and returned in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias,
                            LAYER_NORM_EPS).to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: an ``embedding`` table ``(num, features)``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        std = 1.0 / math.sqrt(self.embedding.shape[1]) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.embedding, std=std, a=-2 * std,
                                  b=2 * std)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.embedding).to(self.dtype)


def dropout_mask(shape, rate: float, generator: torch.Generator,
                 device, dtype) -> torch.Tensor:
    """flax's dropout multiplier: keep (probability ``1 - rate``, drawn as
    ``uniform < 1 - rate`` from ``generator``) over ``1 - rate``, else 0."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(shape, generator=generator, device=device) < keep_prob
    return keep.to(dtype) / torch.tensor(keep_prob, dtype=dtype,
                                         device=device)


def dot_product_attention(query, key, value, mask=None,
                          dropout_rate: float = 0.0,
                          generator: torch.Generator = None) -> torch.Tensor:
    """flax's default attention on ``[B, S, H, D]`` in q's dtype: the query
    scaled by ``1/sqrt(D)``, scores ``[B, H, Sq, Sk]``, masked entries set to
    the dtype's lowest value, softmax over keys, with ``dropout_rate > 0``
    the broadcast dropout (one ``(1, 1, Sq, Sk)`` mask from ``generator``),
    then the values."""
    dt = query.dtype
    query = query / torch.tensor(math.sqrt(query.shape[-1])).to(dt)
    w = torch.einsum("bqhd,bkhd->bhqk", query, key)
    if mask is not None:
        w = torch.where(mask, w, torch.finfo(w.dtype).min)
    w = torch.softmax(w, dim=-1).to(dt)
    if dropout_rate > 0.0:
        w = w * dropout_mask((1, 1) + tuple(w.shape[-2:]), dropout_rate,
                             generator, w.device, dt)
    return torch.einsum("bhqk,bkhd->bqhd", w, value)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention``: ``query``/``key``/``value``
    projections ``(features, heads, head_dim)`` with ``(heads, head_dim)``
    biases, and the ``out`` projection ``(heads, head_dim, features)``, all
    computing in ``dtype``. ``attention_fn`` replaces the default attention
    on the projected ``[B, S, heads, head_dim]`` tensors and is called as
    flax calls it, ``fn(q, k, v, mask=..., dropout_rate=...,
    deterministic=...)``. With ``deterministic=False`` and a dropout rate the
    default attention drops weights with a mask from ``generator``."""

    def __init__(self, features: int, num_heads: int,
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"features ({features}) must divide by "
                             f"num_heads ({num_heads})")
        head_dim = features // num_heads
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.query = DenseGeneral((features,), (num_heads, head_dim), dtype)
        self.key = DenseGeneral((features,), (num_heads, head_dim), dtype)
        self.value = DenseGeneral((features,), (num_heads, head_dim), dtype)
        self.out = DenseGeneral((num_heads, head_dim), (features,), dtype)

    def forward(self, inputs_q, inputs_kv, mask=None, deterministic=True,
                attention_fn=None, generator=None) -> torch.Tensor:
        q, k, v = (self.query(inputs_q), self.key(inputs_kv),
                   self.value(inputs_kv))
        if attention_fn is not None:
            y = attention_fn(q, k, v, mask=mask,
                             dropout_rate=self.dropout_rate,
                             deterministic=deterministic)
        else:
            rate = 0.0 if deterministic else self.dropout_rate
            y = dot_product_attention(q, k, v, mask, rate, generator)
        return self.out(y)


def same_padding(size: int, window: int, stride: int) -> tuple:
    """XLA's ``"SAME"`` padding ``(lo, hi)`` of one spatial dim."""
    total = max((-(-size // stride) - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, window: tuple, strides: tuple, padding) -> list:
    """``[(lo, hi)]`` per spatial dim of NHWC ``x``: ``"SAME"`` or explicit
    pairs."""
    if padding == "SAME":
        return [same_padding(n, k, s) for n, k, s in
                zip(x.shape[1:3], window, strides)]
    return [tuple(p) for p in padding]


def _pad_nhwc(x: torch.Tensor, pads: list, value: float = 0.0):
    (top, bottom), (left, right) = pads
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC input: ``kernel`` ``(kh, kw, in, out)`` and,
    with ``use_bias``, ``bias`` ``(out,)``; computes in ``dtype``.
    ``padding`` is ``"SAME"`` (XLA's) or ``[(lo, hi), (lo, hi)]``."""

    def __init__(self, in_features: int, features: int, kernel_size: tuple,
                 strides: int = 1, padding="SAME", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.strides = (strides, strides)
        self.padding = padding
        self.kernel = nn.Parameter(torch.empty(*kernel_size, in_features,
                                               features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self) -> None:
        lecun_normal_(self.kernel, math.prod(self.kernel.shape[:3]))
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        pads = _pads(x, self.kernel.shape[:2], self.strides, self.padding)
        if all(lo == hi for lo, hi in pads):
            conv_pad = [lo for lo, _ in pads]
        else:
            x, conv_pad = _pad_nhwc(x, pads), 0
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     self.kernel.to(dt).permute(3, 2, 0, 1), bias,
                     self.strides, conv_pad)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis of NHWC input (see the
    module note). ``zero_scale`` starts ``scale`` at 0, as flax's
    ``scale_init=zeros``. ``forward(x, train)``: with ``train`` the batch's
    statistics normalise and update ``mean``/``var`` in place; without, the
    running ones normalise."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train and _STATS_GROUP and _STATS_GROUP[-1] is not None:
            return self._global_batch(x, _STATS_GROUP[-1])
        xc = x.permute(0, 3, 1, 2)
        if train:
            with torch.no_grad():
                var, mean = torch.var_mean(xc.float(), dim=(0, 2, 3),
                                           correction=0)
                m = BATCH_NORM_MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
            y = F.batch_norm(xc, None, None, self.scale, self.bias,
                             training=True, eps=BATCH_NORM_EPS)
        else:
            y = F.batch_norm(xc, self.mean, self.var, self.scale, self.bias,
                             training=False, eps=BATCH_NORM_EPS)
        return y.permute(0, 2, 3, 1).to(self.dtype)

    def _global_batch(self, x: torch.Tensor, group) -> torch.Tensor:
        from ..parallel.collectives import psum

        xf = x.float()
        flat = xf.reshape(-1, xf.shape[-1])
        c = flat.shape[1]
        count = torch.full((1,), float(flat.shape[0]), device=x.device)
        moments = psum(torch.cat([flat.sum(0), (flat * flat).sum(0), count]),
                       group)
        mean = moments[:c] / moments[-1]
        var = torch.clamp_min(moments[c:2 * c] / moments[-1] - mean * mean,
                              0.0)
        with torch.no_grad():
            m = BATCH_NORM_MOMENTUM
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        y = (xf - mean) * (torch.rsqrt(var + BATCH_NORM_EPS) * self.scale)
        return (y + self.bias).to(self.dtype)


def max_pool(x: torch.Tensor, window: tuple, strides: tuple
             ) -> torch.Tensor:
    """flax ``nn.max_pool(..., padding="SAME")`` on NHWC input, padding
    with -inf."""
    pads = _pads(x, window, strides, "SAME")
    x = _pad_nhwc(x, pads, value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, strides)
    return y.permute(0, 2, 3, 1)
