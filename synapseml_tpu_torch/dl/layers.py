"""The flax layers the text encoder is built from, in PyTorch.

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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6


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
        # flax's lecun_normal: truncated normal, variance 1 / fan_in
        fan_in = math.prod(self.kernel.shape[:self._n_in])
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std,
                                  b=2 * std)
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
        std = 1.0 / math.sqrt(self.embedding.shape[1]) / 0.87962566103423978
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
