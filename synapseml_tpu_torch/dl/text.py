"""Text encoder, tokenizer and the text estimators.

Counterpart of the JAX package's ``dl/text.py``: the deterministic
hash-trick tokenizer, ``TransformerEncoder`` and the estimators
``DeepTextClassifier`` / ``DeepTextModel``, which train and score the
encoder through ``dl.trainer.Trainer``. With ``seqParallel=True`` the
encoder is built ``mask_free`` and its attention runs sharded over the
``seq`` axis of a ``{"data": world // sp, "seq": sp}`` mesh of the
initialised ``torch.distributed`` world (``seqAxisSize`` = sp, 0 for the
whole world): every rank calls ``fit`` and ``transform`` with the same
table. Without an initialised world the mesh is one rank and the attention
runs unsharded, as the JAX package does on one device.

The ``checkpoint`` param (a local HuggingFace checkpoint, the JAX package's
``_fit_hf``/``_load_hf``) is not ported: setting it raises
``NotImplementedError``. ``device`` (default ``"cuda"``) is where the model
trains and scores; a missing card raises.
"""

from __future__ import annotations

import os
import re
import zlib
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core import (Estimator, HasLabelCol, HasPredictionCol, Model, Param,
                    Table)
from ..core.device import DEFAULT_DEVICE
from .backbones import active_seq_shard, seq_attention_fn
from .layers import Dense, Embed, LayerNorm, MultiHeadDotProductAttention, gelu
from .trainer import TrainConfig, Trainer, softmax_np

_TOKEN_RE = re.compile(r"[a-z0-9']+")
PAD_ID = 0
CLS_ID = 1
_RESERVED = 2
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    """Pre-LN transformer encoder with [CLS] pooling.

    ``mask_free=True`` drops the PAD attention mask (PAD embeddings are
    learned instead) so that the attention is seq-shardable: inside a
    ``dl.backbones.seq_attention_scope`` it runs through ring or Ulysses
    attention, and outside one the unmasked default computes the same
    values. The parameters are the same either way, named as flax names
    them (``tok_embed``, ``pos_embed``, ``LayerNorm_i``, ``attn_i``,
    ``Dense_i``, ``head``). ``dtype`` (float32 or bfloat16) is the compute
    type, as flax's: parameters stay float32, every layer computes in
    ``dtype`` (LayerNorm statistics in float32) and the head in float32.
    Attention dropout runs in training only, drawn from ``generator``."""

    def __init__(self, vocab_size: int = 32768, num_layers: int = 4,
                 num_heads: int = 8, hidden: int = 256, mlp_ratio: int = 4,
                 max_len: int = 128, num_classes: int = 2,
                 dropout: float = 0.1, mask_free: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.mask_free = mask_free
        self.dtype = dtype
        self.tok_embed = Embed(vocab_size, hidden, dtype)
        self.pos_embed = nn.Parameter(torch.randn(max_len, hidden) * 0.02)
        for i in range(num_layers):
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(hidden, dtype))
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(
                hidden, num_heads, dropout_rate=dropout, dtype=dtype))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(hidden,
                                                                dtype))
            self.add_module(f"Dense_{2 * i}", Dense(
                hidden, hidden * mlp_ratio, dtype))
            self.add_module(f"Dense_{2 * i + 1}", Dense(
                hidden * mlp_ratio, hidden, dtype))
        self.add_module(f"LayerNorm_{2 * num_layers}", LayerNorm(hidden,
                                                                 dtype))
        self.head = Dense(hidden, num_classes)      # float32, as flax's

    def reset_parameters(self) -> None:
        """``pos_embed`` from flax's ``normal(0.02)`` (the layers reset
        their own)."""
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02)

    def forward(self, ids: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``(B, S)`` token ids → ``(B, num_classes)`` float32 logits."""
        mask = ids != PAD_ID
        x = self.tok_embed(ids) + \
            self.pos_embed[None, : ids.shape[1]].to(self.dtype)
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
                                 attention_fn=seq_fn, generator=generator)
            x = x + y
            y = sub[f"LayerNorm_{2 * i + 1}"](x)
            y = sub[f"Dense_{2 * i + 1}"](gelu(sub[f"Dense_{2 * i}"](y)))
            x = x + y
        if shard is not None:
            x = shard.first_token(x)
        x = sub[f"LayerNorm_{2 * self.num_layers}"](x)
        return self.head(x[:, 0])                   # [CLS] pooling


def _unported_checkpoint() -> NotImplementedError:
    return NotImplementedError(
        "the checkpoint param (a local HuggingFace checkpoint) is not "
        "ported to the PyTorch package yet")


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


class DeepTextClassifier(Estimator, HasLabelCol, HasPredictionCol):
    checkpoint = Param("checkpoint", "Local HuggingFace checkpoint dir "
                       "(not ported)", str)
    textCol = Param("textCol", "Input text column", str, "text")
    maxTokenLen = Param("maxTokenLen", "Truncation length", int, 128)
    batchSize = Param("batchSize", "Training batch size", int, 16)
    maxEpochs = Param("maxEpochs", "Training epochs", int, 1)
    learningRate = Param("learningRate", "Learning rate", float, 1e-4)
    optimizer = Param("optimizer", "adam/adamw/sgd/momentum", str, "adamw")
    vocabSize = Param("vocabSize", "Hash-bucket vocabulary size", int, 32768)
    numLayers = Param("numLayers", "Encoder layers", int, 4)
    numHeads = Param("numHeads", "Attention heads", int, 8)
    hiddenSize = Param("hiddenSize", "Hidden width", int, 256)
    precision = Param("precision", "float32 or bfloat16 compute", str,
                      "float32")
    seed = Param("seed", "Random seed", int, 0)
    seqParallel = Param(
        "seqParallel", "Shard attention over a mesh 'seq' axis (mask-free "
        "attention; attention dropout disabled)", bool, False)
    seqAxisSize = Param(
        "seqAxisSize", "Ranks on the 'seq' mesh axis (0 = the whole "
        "torch.distributed world)", int, 0)
    seqAttention = Param(
        "seqAttention", "Sequence-attention variant: auto (analytic prior) "
        "/ ring / ulysses", str, "auto")
    stepsPerEpoch = Param("stepsPerEpoch", "Steps per epoch (0 = every full "
                          "batch)", int, 0)
    device = Param("device", "Device that trains and scores the model: "
                   "'cuda' (default) or 'cpu'", str, DEFAULT_DEVICE)

    def set(self, name: str, value) -> "DeepTextClassifier":
        if name == "checkpoint" and value:
            raise _unported_checkpoint()
        return super().set(name, value)

    def _mesh(self):
        if not self.getSeqParallel() or _world_size() == 1:
            return None
        from ..parallel.mesh import data_seq_mesh

        return data_seq_mesh(self.getSeqAxisSize(), self.getDevice())

    def _encoder(self, num_classes: int) -> TransformerEncoder:
        """The encoder this estimator trains, its parameters drawn on the CPU
        from ``seed`` (the same on every rank)."""
        seq_on = bool(self.getSeqParallel())
        with torch.random.fork_rng(devices=[]):
            torch.random.default_generator.manual_seed(self.getSeed())
            return TransformerEncoder(
                vocab_size=self.getVocabSize(),
                num_layers=self.getNumLayers(),
                num_heads=self.getNumHeads(), hidden=self.getHiddenSize(),
                max_len=self.getMaxTokenLen(), num_classes=num_classes,
                dtype=_DTYPES[self.getPrecision()], mask_free=seq_on,
                dropout=0.0 if seq_on else 0.1)

    def _fit(self, df: Table) -> "DeepTextModel":
        if self.get("checkpoint"):
            raise _unported_checkpoint()
        if self.getPrecision() not in _DTYPES:
            raise ValueError(f"precision must be float32 or bfloat16, got "
                             f"{self.getPrecision()!r}")
        texts = list(df[self.getTextCol()])
        labels_raw = np.asarray(df[self.getLabelCol()])
        classes, y = np.unique(labels_raw, return_inverse=True)
        ids = hash_tokenize(texts, self.getVocabSize(), self.getMaxTokenLen())
        seq_on = bool(self.getSeqParallel())
        model = self._encoder(len(classes))
        cfg = TrainConfig(batch_size=self.getBatchSize(),
                          max_epochs=self.getMaxEpochs(),
                          learning_rate=self.getLearningRate(),
                          optimizer=self.getOptimizer(),
                          compute_dtype=self.getPrecision(),
                          seed=self.getSeed(), seq_parallel=seq_on,
                          seq_attention=self.getSeqAttention(),
                          steps_per_epoch=self.getStepsPerEpoch() or None)
        trainer = Trainer(model, cfg, mesh=self._mesh(),
                          device=self.getDevice())
        trainer.fit(ids, y, log_fn=lambda ep: self._log_base("epoch", ep))

        m = DeepTextModel(trainer=trainer, classes=classes)
        for p in ("seqParallel", "vocabSize", "maxTokenLen", "numLayers",
                  "numHeads", "hiddenSize", "precision", "batchSize",
                  "device"):
            m.set(p, self.get(p))
        for p in ("textCol", "predictionCol"):
            if self.isSet(p):
                m.set(p, self.get(p))
        return m


class DeepTextModel(Model, HasPredictionCol):
    textCol = Param("textCol", "Input text column", str, "text")
    maxTokenLen = Param("maxTokenLen", "Truncation length", int, 128)
    vocabSize = Param("vocabSize", "Hash-bucket vocabulary size", int, 32768)
    numLayers = Param("numLayers", "Encoder layers", int, 4)
    numHeads = Param("numHeads", "Attention heads", int, 8)
    hiddenSize = Param("hiddenSize", "Hidden width", int, 256)
    precision = Param("precision", "float32 or bfloat16 compute", str,
                      "float32")
    batchSize = Param("batchSize", "Scoring batch size", int, 16)
    seqParallel = Param(
        "seqParallel", "Model was trained mask-free for seq sharding", bool,
        False)
    device = Param("device", "Device that scores the model: 'cuda' "
                   "(default) or 'cpu'", str, DEFAULT_DEVICE)

    # class-level defaults: instances materialized by PipelineStage.load
    # bypass __init__
    trainer: Optional[Trainer] = None
    classes: Optional[np.ndarray] = None

    def __init__(self, trainer: Optional[Trainer] = None,
                 classes: Optional[np.ndarray] = None, hfModel=None,
                 hfTokenizer=None, **kwargs):
        for name, value in (("hfModel", hfModel),
                            ("hfTokenizer", hfTokenizer)):
            if value is not None:
                raise NotImplementedError(
                    f"DeepTextModel's {name} (a HuggingFace model behind the "
                    "checkpoint param) is not ported to the PyTorch package "
                    "yet")
        super().__init__(**kwargs)
        self.trainer = trainer
        self.classes = classes

    def _transform(self, df: Table) -> Table:
        texts = list(df[self.getTextCol()])
        ids = hash_tokenize(texts, self.getVocabSize(), self.getMaxTokenLen())
        logits = self.trainer.predict_logits(ids)
        pred = np.asarray(self.classes)[logits.argmax(-1)]
        out = df.with_column(self.getPredictionCol(), pred)
        return out.with_column("probability", softmax_np(logits))

    def _save_extra(self, path: str) -> None:
        """``classes.npy`` and ``params.msgpack``: flax's msgpack of
        ``{"params": tree}``, float32, keys sorted as a fitted flax tree's
        (the JAX estimator's file, byte for byte, for the same weights)."""
        from ..convert import text_encoder_to_reference
        from ..core.serialization import to_bytes
        from .trainer import nest_sorted

        np.save(os.path.join(path, "classes.npy"), np.asarray(self.classes))
        flat = text_encoder_to_reference(self.trainer.model.state_dict(),
                                         nested=False)
        with open(os.path.join(path, "params.msgpack"), "wb") as f:
            f.write(to_bytes({"params": nest_sorted(flat)}))

    def _load_extra(self, path: str) -> None:
        """Reads ``params.msgpack`` (either package's), or the
        ``params.npz`` of earlier versions of this package."""
        from ..convert import text_encoder_from_reference
        from ..core.serialization import msgpack_restore

        self.classes = np.load(os.path.join(path, "classes.npy"),
                               allow_pickle=True)
        model = TransformerEncoder(
            vocab_size=self.getVocabSize(), num_layers=self.getNumLayers(),
            num_heads=self.getNumHeads(), hidden=self.getHiddenSize(),
            max_len=self.getMaxTokenLen(), num_classes=len(self.classes),
            dtype=_DTYPES[self.getPrecision()],
            mask_free=bool(self.getSeqParallel()))
        blob = os.path.join(path, "params.msgpack")
        if os.path.exists(blob):
            with open(blob, "rb") as f:
                flat = msgpack_restore(f.read())["params"]
        else:
            with np.load(os.path.join(path, "params.npz")) as f:
                flat = {k: f[k] for k in f.files}
        trainer = Trainer(model, TrainConfig(batch_size=self.getBatchSize()),
                          device=self.getDevice())
        trainer.load_params(text_encoder_from_reference(flat))
        self.trainer = trainer
