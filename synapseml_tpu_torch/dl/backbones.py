"""Vision backbones, transformer units and sequence-parallel attention
routing.

Counterpart of the JAX package's ``dl/backbones.py``: the ResNets and
``TinyCNN`` with ``BACKBONES``/``make_backbone``, and the text part
(``TextEmbedUnit``, ``TransformerLayerUnit``, ``TextClsHead`` and the
``seq`` routing), and the pipeline staging: ``StageGroup`` and
``StageSequential``, the units ``ResNetStem``, ``ConvReluUnit`` and
``PoolDenseHead``, ``stage_units``, ``partition_stages``,
``make_staged_backbone`` and ``staged_text_encoder``.

Staging. ``StageSequential`` holds its stages as ``stages_{k}`` and each
``StageGroup`` its units as ``units_{j}``, the names flax gives a tuple
field of modules, so ``named_parameters`` is the JAX package's staged
parameter tree flattened with ``.`` (``stages_0.units_1.Conv_0.kernel``).
Applied whole, a ``StageSequential`` is exactly the unsplit model (the
replicated and ZeRO trainer run it unchanged); ``model.stages[k]`` runs
alone on its own subtree (``dl.pipeline``). Every unit is called as
``unit(x, train=..., generator=...)``.

The vision backbones take NHWC images and keep flax's module names
(``stem_conv``, ``stem_bn``, ``BottleneckBlock_3.Conv_1``, ``head``), so
their ``state_dict`` is the flattened flax tree, ``params`` and
``batch_stats`` alike (``convert.resnet_from_reference``). flax infers the
input channels at ``init``; here ``in_channels`` (default 3) says them.
``forward(x, train=False, generator=None)``: with ``train`` every
BatchNorm normalises with the batch's statistics and updates its running
ones. With ``dtype=torch.bfloat16`` the layers compute in bf16 (BatchNorm
in float32) and the head in float32, as flax's. Inside ``seq_attention_scope(mesh, variant)`` the
attention of ``TransformerLayerUnit`` and of a mask-free
``dl.text.TransformerEncoder`` runs sharded over the mesh's ``seq`` axis
(ring or Ulysses) instead of the default attention, with the same
parameters; outside a scope, or on a mesh whose ``seq`` axis has fewer than
2 ranks, the default attention applies.

Every rank of the mesh runs the model on the same global inputs and gets
the same global outputs, as under the JAX package's ``shard_map``. In
between, a rank holds only its shard of the activations: the module cuts
this rank's (batch, sequence) shard once (``SeqShard.take``), runs its
layers on it (everything but attention is per token; the attention function
``seq_attention_fn`` gives works on shards) and gathers once at its end
(``SeqShard.gather``, or ``SeqShard.first_token`` before the encoder's
[CLS] head).
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_gather
from ..parallel.mesh import DATA_AXIS, SEQ_AXIS
from .layers import (BatchNorm, Conv, Dense, Embed, LayerNorm,
                     MultiHeadDotProductAttention, dropout_mask, gelu,
                     max_pool)

_SEQ_SCOPE: list = []


class TextEmbedUnit(nn.Module):
    """Token + learned positional embedding (first stage of the staged text
    encoder)."""

    def __init__(self, vocab_size: int, hidden: int, max_len: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Embed_0 = Embed(vocab_size, hidden, dtype)
        self.pos_embed = nn.Parameter(torch.randn(max_len, hidden) * 0.02)

    def reset_parameters(self) -> None:
        """``pos_embed`` from flax's ``normal(0.02)`` (the layers reset
        their own)."""
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02)

    def forward(self, ids: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.Embed_0(ids)
        return x + self.pos_embed[None, : x.shape[1]].to(x.dtype)


@contextlib.contextmanager
def seq_attention_scope(mesh, variant: str = "ring"):
    """Route the attention of ``TransformerLayerUnit`` and of a mask-free
    ``TransformerEncoder`` over ``mesh``'s ``seq`` axis for every forward
    run inside the scope. ``variant`` is "ring" (K/V rotation) or "ulysses"
    (all-to-all head scatter)."""
    _SEQ_SCOPE.append((mesh, variant))
    try:
        yield
    finally:
        _SEQ_SCOPE.pop()


def active_seq_mesh():
    """The (mesh, variant) of the innermost active scope whose mesh carries
    a ``seq`` axis of size > 1, else None."""
    if not _SEQ_SCOPE:
        return None
    mesh, variant = _SEQ_SCOPE[-1]
    if mesh is None or SEQ_AXIS not in mesh.shape or mesh.shape[SEQ_AXIS] < 2:
        return None
    return mesh, variant


class SeqShard:
    """This rank's (batch, sequence) shard of global ``[B, S, ...]``
    activations on ``mesh``: a sequence that does not divide the ``seq``
    axis is zero-padded up to the shard grid, and ``kv_len`` (None when
    nothing was padded) tells the attention to drop the padded keys; the
    batch rides the ``data`` axis when there is one and it divides B."""

    def __init__(self, mesh, batch: int, seq_len: int):
        self.mesh, self.seq_len = mesh, seq_len
        sp = mesh.shape[SEQ_AXIS]
        self.pad = (-seq_len) % sp
        self.kv_len = seq_len if self.pad else None
        shard = (seq_len + self.pad) // sp
        i = mesh.axis_index(SEQ_AXIS)
        self.seq = slice(i * shard, (i + 1) * shard)
        dp = mesh.shape.get(DATA_AXIS, 1)
        self.by_data = dp > 1 and batch % dp == 0
        self.rows = slice(None)
        if self.by_data:
            b = batch // dp
            j = mesh.axis_index(DATA_AXIS)
            self.rows = slice(j * b, (j + 1) * b)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the global ``x``."""
        if self.pad:
            x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, self.pad))
        return x[self.rows, self.seq]

    def _gather_rows(self, y: torch.Tensor) -> torch.Tensor:
        return (all_gather(y, self.mesh.group(DATA_AXIS), axis=0)
                if self.by_data else y)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The global tensor of every rank's shard ``y``, padding removed."""
        y = all_gather(y, self.mesh.group(SEQ_AXIS), axis=1)
        return self._gather_rows(y[:, :self.seq_len])

    def first_token(self, y: torch.Tensor) -> torch.Tensor:
        """Global position 0 of every row, ``[B, 1, ...]`` (the first
        ``seq`` rank holds it)."""
        y = all_gather(y[:, :1], self.mesh.group(SEQ_AXIS), axis=1)
        return self._gather_rows(y[:, :1])


def active_seq_shard(x: torch.Tensor) -> Optional[SeqShard]:
    """The ``SeqShard`` of the global activations ``x`` on the active
    scope's mesh, or None when no scope is active."""
    active = active_seq_mesh()
    return None if active is None else SeqShard(active[0], *x.shape[:2])


def _variant_fn(variant: str):
    from ..parallel.ring_attention import ring_self_attention
    from ..parallel.ulysses import ulysses_self_attention

    if variant not in ("ring", "ulysses"):
        raise ValueError(f"unknown seq attention variant {variant!r}; "
                         "expected 'ring' or 'ulysses'")
    return ring_self_attention if variant == "ring" else \
        ulysses_self_attention


def sharded_self_attention(q, k, v, mesh, variant: str = "ring",
                           causal: bool = False, scale=None) -> torch.Tensor:
    """Seq-sharded self-attention of the global ``[B, S, H, D]`` q/k/v (the
    same on every rank of ``mesh``); returns the global output on every
    rank: this rank's shard is cut, run through the variant and gathered
    back (see ``SeqShard`` for padding and the batch)."""
    fn = _variant_fn(variant)
    shard = SeqShard(mesh, *q.shape[:2])
    out = fn(shard.take(q), shard.take(k), shard.take(v), mesh,
             causal=causal, scale=scale, kv_len=shard.kv_len)
    return shard.gather(out)


def seq_attention_fn(kv_len: Optional[int] = None) -> Optional[Any]:
    """An ``attention_fn`` for ``MultiHeadDotProductAttention`` that runs
    the scoped seq-sharded variant on THIS rank's shard of q/k/v (cut by a
    ``SeqShard``, whose ``kv_len`` it takes), or None when no scope is
    active (the default attention applies)."""
    active = active_seq_mesh()
    if active is None:
        return None
    mesh, variant = active
    fn = _variant_fn(variant)

    def _attn(query, key, value, mask=None, dropout_rate: float = 0.0,
              deterministic: bool = True, **_kw):
        if mask is not None:
            raise ValueError("sequence-parallel attention is mask-free "
                             "(TransformerLayerUnit's contract); got a mask")
        if dropout_rate and not deterministic:
            raise ValueError("attention-weight dropout is unsupported under "
                             "sequence parallelism; set dropout=0.0")
        return fn(query, key, value, mesh, kv_len=kv_len)

    return _attn


class TransformerLayerUnit(nn.Module):
    """One pre-LN transformer encoder layer as a pipeline unit, attending
    over the full window without a padding mask. Inside a
    ``seq_attention_scope`` the attention runs seq-sharded (ring or
    Ulysses) with the same parameters. In training, ``dropout`` drops
    attention weights and the MLP's output (flax ``nn.Dropout``, an
    elementwise mask) with masks from ``generator``; under sequence
    parallelism dropout is refused."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.LayerNorm_0 = LayerNorm(hidden, dtype)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            hidden, heads, dropout_rate=dropout, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(hidden, dtype)
        self.Dense_0 = Dense(hidden, mlp_dim, dtype)
        self.Dense_1 = Dense(mlp_dim, hidden, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        shard = active_seq_shard(x)
        if shard is not None:
            x = shard.take(x)
        h = self.LayerNorm_0(x)
        h = self.MultiHeadDotProductAttention_0(
            h, h, deterministic=not train,
            attention_fn=seq_attention_fn(None if shard is None
                                          else shard.kv_len),
            generator=generator)
        x = x + h
        h = self.LayerNorm_1(x)
        h = self.Dense_1(gelu(self.Dense_0(h)))
        if self.dropout and train:
            h = h * dropout_mask(h.shape, self.dropout, generator, h.device,
                                 h.dtype)
        x = x + h
        return x if shard is None else shard.gather(x)


class TextClsHead(nn.Module):
    """LayerNorm + first-token (CLS) classifier head unit."""

    def __init__(self, hidden: int, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden, dtype)
        self.head = Dense(hidden, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.head(self.LayerNorm_0(x)[:, 0])


class ResNetBlock(nn.Module):
    """Two 3x3 convolutions (the first with ``strides``), each followed by
    BatchNorm, the second's scale starting at 0; a 1x1 projection
    (``Conv_2``/``BatchNorm_2``) where the shape changes."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, (3, 3), strides,
                           use_bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), use_bias=False,
                           dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype, zero_scale=True)
        if in_features != filters or strides != 1:
            self.Conv_2 = Conv(in_features, filters, (1, 1), strides,
                               use_bias=False, dtype=dtype)
            self.BatchNorm_2 = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        if hasattr(self, "Conv_2"):
            x = self.BatchNorm_2(self.Conv_2(x), train)
        return F.relu(y + x)


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (with ``strides``) and 1x1 to ``4 * filters`` convolutions,
    each followed by BatchNorm, the last's scale starting at 0; a 1x1
    projection (``Conv_3``/``BatchNorm_3``) where the shape changes."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_features, filters, (1, 1), use_bias=False,
                           dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, use_bias=False,
                           dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.Conv_2 = Conv(filters, out, (1, 1), use_bias=False, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(out, dtype, zero_scale=True)
        if in_features != out or strides != 1:
            self.Conv_3 = Conv(in_features, out, (1, 1), strides,
                               use_bias=False, dtype=dtype)
            self.BatchNorm_3 = BatchNorm(out, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        if hasattr(self, "Conv_3"):
            x = self.BatchNorm_3(self.Conv_3(x), train)
        return F.relu(y + x)


class ResNet(nn.Module):
    """NHWC ResNet; ``num_classes=0`` gives the headless feature extractor
    (pooled features). ``small_images``: the CIFAR stem (3x3 convolution,
    no max-pool) in place of the ImageNet one (7x7 stride 2, padding 3,
    then a 3x3 stride-2 ``"SAME"`` max-pool)."""

    def __init__(self, stage_sizes, block, num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.float32,
                 small_images: bool = False, in_channels: int = 3):
        super().__init__()
        self.small_images = small_images
        if small_images:
            self.stem_conv = Conv(in_channels, width, (3, 3), use_bias=False,
                                  dtype=dtype)
        else:
            self.stem_conv = Conv(in_channels, width, (7, 7), 2,
                                  [(3, 3), (3, 3)], use_bias=False,
                                  dtype=dtype)
        self.stem_bn = BatchNorm(width, dtype)
        self.blocks = []
        features = width
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                strides = 2 if i > 0 and j == 0 else 1
                name = f"{block.__name__}_{len(self.blocks)}"
                self.add_module(name, block(features, width * 2 ** i,
                                            strides, dtype))
                self.blocks.append(name)
                features = width * 2 ** i * block.expansion
        self.head = Dense(features, num_classes) if num_classes else None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        if not self.small_images:
            x = max_pool(x, (3, 3), (2, 2))
        for name in self.blocks:
            x = self._modules[name](x, train)
        x = x.mean(dim=(1, 2))                    # global average pool
        return x if self.head is None else self.head(x)


def resnet18(num_classes=1000, **kw) -> ResNet:
    return ResNet([2, 2, 2, 2], ResNetBlock, num_classes, **kw)


def resnet34(num_classes=1000, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], ResNetBlock, num_classes, **kw)


def resnet50(num_classes=1000, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes, **kw)


def resnet101(num_classes=1000, **kw) -> ResNet:
    return ResNet([3, 4, 23, 3], BottleneckBlock, num_classes, **kw)


class TinyCNN(nn.Module):
    """Two 3x3 stride-2 convolutions with bias and relu, the global mean
    pool and a float32 head: the small backbone of the tests."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__()
        self.Conv_0 = Conv(in_channels, 16, (3, 3), 2, dtype=dtype)
        self.Conv_1 = Conv(16, 32, (3, 3), 2, dtype=dtype)
        self.head = Dense(32, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        return self.head(x.mean(dim=(1, 2)))


# --- pipeline staging --------------------------------------------------------
# MPMD pipeline parallelism (dl/pipeline.py) needs the backbone as a
# SEQUENCE of units a partitioner cuts into stages.


class StageGroup(nn.Module):
    """One pipeline stage: a sequential run of units, held as
    ``units_{j}``."""

    def __init__(self, units):
        super().__init__()
        self.num_units = len(units)
        for j, u in enumerate(units):
            self.add_module(f"units_{j}", u)

    @property
    def units(self) -> list:
        return [self._modules[f"units_{j}"] for j in range(self.num_units)]

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for u in self.units:
            x = u(x, train=train, generator=generator)
        return x


class StageSequential(nn.Module):
    """A backbone split into pipeline stages, held as ``stages_{k}``.
    Applying the whole module is exactly the unsplit model; the pipeline
    instead runs each ``stages[k]`` on its own stage group."""

    def __init__(self, stages):
        super().__init__()
        self.num_stages = len(stages)
        for k, st in enumerate(stages):
            self.add_module(f"stages_{k}", st)

    @property
    def stages(self) -> list:
        return [self._modules[f"stages_{k}"] for k in range(self.num_stages)]

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for st in self.stages:
            x = st(x, train=train, generator=generator)
        return x


class ResNetStem(nn.Module):
    """The ResNet stem as a unit: convolution, BatchNorm and relu, then
    (ImageNet stem) the 3x3 stride-2 max-pool."""

    def __init__(self, width: int = 64, dtype: torch.dtype = torch.float32,
                 small_images: bool = False, in_channels: int = 3):
        super().__init__()
        self.small_images = small_images
        if small_images:
            self.stem_conv = Conv(in_channels, width, (3, 3), use_bias=False,
                                  dtype=dtype)
        else:
            self.stem_conv = Conv(in_channels, width, (7, 7), 2,
                                  [(3, 3), (3, 3)], use_bias=False,
                                  dtype=dtype)
        self.stem_bn = BatchNorm(width, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        return x if self.small_images else max_pool(x, (3, 3), (2, 2))


class ConvReluUnit(nn.Module):
    """``TinyCNN``'s convolution and relu as a unit (no BatchNorm or
    dropout)."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (3, 3), strides,
                           dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return F.relu(self.Conv_0(x))


class PoolDenseHead(nn.Module):
    """The global average pool and the float32 classifier head as a
    unit."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.head = Dense(in_features, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.head(x.mean(dim=(1, 2)))


def stage_units(name: str, num_classes: int,
                dtype: torch.dtype = torch.float32,
                small_images: bool = False, width: int = 64,
                in_channels: int = 3) -> list:
    """The sequential unit list of a vision backbone, which
    ``partition_stages`` groups into pipeline stages."""
    if name == "tiny":
        return [ConvReluUnit(in_channels, 16, 2), ConvReluUnit(16, 32, 2),
                PoolDenseHead(32, num_classes)]
    specs = {"resnet18": ([2, 2, 2, 2], ResNetBlock),
             "resnet34": ([3, 4, 6, 3], ResNetBlock),
             "resnet50": ([3, 4, 6, 3], BottleneckBlock),
             "resnet101": ([3, 4, 23, 3], BottleneckBlock)}
    if name not in specs:
        raise ValueError(
            f"no staged form for backbone {name!r}; available: "
            f"{sorted(specs) + ['tiny']}")
    stage_sizes, block = specs[name]
    units: list = [ResNetStem(width, dtype, small_images, in_channels)]
    features = width
    for i, size in enumerate(stage_sizes):
        for j in range(size):
            strides = 2 if i > 0 and j == 0 else 1
            units.append(block(features, width * 2 ** i, strides, dtype))
            features = width * 2 ** i * block.expansion
    units.append(PoolDenseHead(features, num_classes))
    return units


def partition_stages(units, num_stages: int,
                     unit_costs=None) -> StageSequential:
    """Cut a unit list into ``num_stages`` contiguous stages: by default
    size-balanced (the remainder units go to the earliest stages); with
    ``unit_costs`` (one non-negative cost per unit) cost-balanced through
    ``core.perfmodel.suggest_stage_cuts`` (min-max contiguous partition)."""
    if not 1 <= num_stages <= len(units):
        raise ValueError(
            f"num_stages={num_stages} must be in [1, {len(units)}] for a "
            f"{len(units)}-unit backbone")
    if unit_costs is not None:
        if len(unit_costs) != len(units):
            raise ValueError(
                f"unit_costs has {len(unit_costs)} entries for "
                f"{len(units)} units")
        from ..core.perfmodel import suggest_stage_cuts

        sizes, _dec = suggest_stage_cuts(unit_costs, num_stages)
    else:
        k, m = divmod(len(units), num_stages)
        sizes = [k + (1 if i < m else 0) for i in range(num_stages)]
    groups, at = [], 0
    for sz in sizes:
        groups.append(StageGroup(list(units[at: at + sz])))
        at += sz
    return StageSequential(groups)


def make_staged_backbone(name: str, num_classes: int, num_stages: int,
                         dtype: torch.dtype = torch.float32,
                         small_images: bool = False, width: int = 64,
                         in_channels: int = 3) -> StageSequential:
    """A vision backbone pre-cut into ``num_stages`` pipeline stages."""
    return partition_stages(
        stage_units(name, num_classes, dtype=dtype, small_images=small_images,
                    width=width, in_channels=in_channels), num_stages)


def staged_text_encoder(vocab_size: int, num_classes: int, num_stages: int,
                        num_layers: int = 4, hidden: int = 128, heads: int = 4,
                        mlp_dim: int = 0, max_len: int = 128,
                        dropout: float = 0.0,
                        dtype: torch.dtype = torch.float32
                        ) -> StageSequential:
    """A BERT-style encoder pre-cut into pipeline stages: the embedding
    unit, ``num_layers`` mask-free transformer layers and the [CLS] head."""
    units = [TextEmbedUnit(vocab_size, hidden, max_len, dtype)]
    units += [TransformerLayerUnit(hidden, heads, mlp_dim or hidden * 4,
                                   dropout, dtype)
              for _ in range(num_layers)]
    units.append(TextClsHead(hidden, num_classes, dtype))
    return partition_stages(units, num_stages)


BACKBONES: dict = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "tiny": lambda num_classes=10, in_channels=3, **kw: TinyCNN(
        num_classes=num_classes, in_channels=in_channels),
}


def make_backbone(name: str, num_classes: int,
                  dtype: torch.dtype = torch.float32,
                  small_images: bool = False, in_channels: int = 3):
    """The named backbone; ``"tiny"`` ignores ``dtype`` and
    ``small_images``, as the JAX package's does."""
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}; available: "
                         f"{sorted(BACKBONES)}")
    return BACKBONES[name](num_classes=num_classes, dtype=dtype,
                           small_images=small_images,
                           in_channels=in_channels)
