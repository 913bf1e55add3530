"""Text encoder and tokenizer.

Counterpart of the encoder part of the JAX package's ``dl/text.py``: the
deterministic hash-trick tokenizer and ``TransformerEncoder``, the model
``DeepTextClassifier`` builds (with ``seqParallel=True`` it is built
``mask_free``). The estimators wait for the trainer slice.
"""

from __future__ import annotations

import re
import zlib

import numpy as np
import torch
from torch import nn

from .backbones import active_seq_shard, seq_attention_fn
from .layers import Dense, Embed, LayerNorm, MultiHeadDotProductAttention, gelu

_TOKEN_RE = re.compile(r"[a-z0-9']+")
PAD_ID = 0
CLS_ID = 1
_RESERVED = 2


def hash_tokenize(texts, vocab_size: int, max_len: int) -> np.ndarray:
    """Deterministic hash-trick tokenizer (crc32 buckets): lowercase word
    split → bucket ids; [CLS] prepended; zero-padded. ``(len(texts),
    max_len)`` int32."""
    out = np.zeros((len(texts), max_len), np.int32)
    out[:, 0] = CLS_ID
    usable = vocab_size - _RESERVED
    for i, t in enumerate(texts):
        toks = _TOKEN_RE.findall(str(t).lower())[: max_len - 1]
        for j, tok in enumerate(toks):
            out[i, j + 1] = _RESERVED + (zlib.crc32(tok.encode()) % usable)
    return out


class TransformerEncoder(nn.Module):
    """Pre-LN transformer encoder with [CLS] pooling, float32.

    ``mask_free=True`` drops the PAD attention mask (PAD embeddings are
    learned instead) so that the attention is seq-shardable: inside a
    ``dl.backbones.seq_attention_scope`` it runs through ring or Ulysses
    attention, and outside one the unmasked default computes the same
    values. The parameters are the same either way, named as flax names
    them (``tok_embed``, ``pos_embed``, ``LayerNorm_i``, ``attn_i``,
    ``Dense_i``, ``head``). Dropout runs only in training, which is not
    ported yet: ``train=True`` with ``dropout > 0`` raises."""

    def __init__(self, vocab_size: int = 32768, num_layers: int = 4,
                 num_heads: int = 8, hidden: int = 256, mlp_ratio: int = 4,
                 max_len: int = 128, num_classes: int = 2,
                 dropout: float = 0.1, mask_free: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.mask_free = mask_free
        self.tok_embed = Embed(vocab_size, hidden)
        self.pos_embed = nn.Parameter(torch.randn(max_len, hidden) * 0.02)
        for i in range(num_layers):
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(hidden))
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(
                hidden, num_heads, dropout_rate=dropout))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(hidden))
            self.add_module(f"Dense_{2 * i}", Dense(hidden,
                                                    hidden * mlp_ratio))
            self.add_module(f"Dense_{2 * i + 1}", Dense(hidden * mlp_ratio,
                                                        hidden))
        self.add_module(f"LayerNorm_{2 * num_layers}", LayerNorm(hidden))
        self.head = Dense(hidden, num_classes)

    def forward(self, ids: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``(B, S)`` token ids → ``(B, num_classes)`` float32 logits."""
        mask = ids != PAD_ID
        x = self.tok_embed(ids) + self.pos_embed[None, : ids.shape[1]]
        attn_mask = (None if self.mask_free
                     else mask[:, None, None, :] & mask[:, None, :, None])
        # in a seq scope the layers run on this rank's shard of the tokens
        shard = active_seq_shard(x) if self.mask_free else None
        seq_fn = None
        if shard is not None:
            x = shard.take(x)
            seq_fn = seq_attention_fn(shard.kv_len)
        sub = self._modules
        for i in range(self.num_layers):
            y = sub[f"LayerNorm_{2 * i}"](x)
            y = sub[f"attn_{i}"](y, y, mask=attn_mask, deterministic=not train,
                                 attention_fn=seq_fn)
            x = x + y
            y = sub[f"LayerNorm_{2 * i + 1}"](x)
            y = sub[f"Dense_{2 * i + 1}"](gelu(sub[f"Dense_{2 * i}"](y)))
            x = x + y
        if shard is not None:
            x = shard.first_token(x)
        x = sub[f"LayerNorm_{2 * self.num_layers}"](x)
        return self.head(x[:, 0])                   # [CLS] pooling
