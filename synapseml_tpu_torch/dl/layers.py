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

    def __init__(self, in_shape: tuple, out_shape: tuple):
        super().__init__()
        self._n_in = len(in_shape)
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))
        # flax's lecun_normal: truncated normal, variance 1 / fan_in
        std = 1.0 / math.sqrt(math.prod(in_shape)) / 0.87962566103423978
        nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std, b=2 * std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(x, self.kernel, dims=self._n_in) + self.bias


def Dense(in_features: int, out_features: int) -> DenseGeneral:
    """flax ``nn.Dense``: kernel ``(in, out)`` and bias ``(out,)``."""
    return DenseGeneral((in_features,), (out_features,))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: ``scale`` and ``bias``,
    epsilon 1e-6."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias,
                            LAYER_NORM_EPS)


class Embed(nn.Module):
    """flax ``nn.Embed``: an ``embedding`` table ``(num, features)``."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        std = 1.0 / math.sqrt(features) / 0.87962566103423978
        nn.init.trunc_normal_(self.embedding, std=std, a=-2 * std, b=2 * std)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.embedding)


def dot_product_attention(query, key, value, mask=None) -> torch.Tensor:
    """flax's default attention on ``[B, S, H, D]``: the query scaled by
    ``1/sqrt(D)``, scores ``[B, H, Sq, Sk]``, masked entries set to the
    dtype's lowest value, softmax over keys, then the values."""
    query = query / math.sqrt(query.shape[-1])
    w = torch.einsum("bqhd,bkhd->bhqk", query, key)
    if mask is not None:
        w = torch.where(mask, w, torch.finfo(w.dtype).min)
    w = torch.softmax(w, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, value)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (no dropout in this port):
    ``query``/``key``/``value`` projections ``(features, heads, head_dim)``
    with ``(heads, head_dim)`` biases, and the ``out`` projection
    ``(heads, head_dim, features)``. ``attention_fn`` replaces the default
    attention on the projected ``[B, S, heads, head_dim]`` tensors and is
    called as flax calls it, ``fn(q, k, v, mask=..., dropout_rate=...,
    deterministic=...)``."""

    def __init__(self, features: int, num_heads: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"features ({features}) must divide by "
                             f"num_heads ({num_heads})")
        head_dim = features // num_heads
        self.dropout_rate = dropout_rate
        self.query = DenseGeneral((features,), (num_heads, head_dim))
        self.key = DenseGeneral((features,), (num_heads, head_dim))
        self.value = DenseGeneral((features,), (num_heads, head_dim))
        self.out = DenseGeneral((num_heads, head_dim), (features,))

    def forward(self, inputs_q, inputs_kv, mask=None, deterministic=True,
                attention_fn=None) -> torch.Tensor:
        q, k, v = (self.query(inputs_q), self.key(inputs_kv),
                   self.value(inputs_kv))
        if attention_fn is not None:
            y = attention_fn(q, k, v, mask=mask,
                             dropout_rate=self.dropout_rate,
                             deterministic=deterministic)
        else:
            if self.dropout_rate and not deterministic:
                raise NotImplementedError(
                    "attention dropout in training is not ported yet; "
                    "run with train=False or dropout=0.0")
            y = dot_product_attention(q, k, v, mask)
        return self.out(y)
