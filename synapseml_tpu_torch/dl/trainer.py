"""The supervised fine-tune loop of the DL estimators.

Counterpart of the JAX package's ``dl/trainer.py``: ``TrainConfig`` with its
fields and defaults, the optimizers of ``_make_tx``, ``freeze_mask`` and
``Trainer``, the counterpart of ``FlaxTrainer`` (replicated or ZeRO
parameters, with or without a ``seq`` mesh axis), with its epoch
checkpoints, resume and non-finite loss policies.

Optimizers follow optax, not ``torch.optim``'s defaults:

* adam and adamw: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction; adamw adds ``weight_decay · p`` to the update before the
  learning rate scales it. sgd has no momentum; momentum is 0.9, not
  Nesterov.
* schedules count updates from 0 as optax does: ``lr_schedule="cosine"`` is
  ``warmup_cosine_decay_schedule(0, lr, max(warmup, 1), total)`` and so
  gives learning rate 0 at the first update; ``"constant"`` is ``lr``, or a
  linear warmup from 0 to ``lr`` when ``warmup_steps > 0``.
* ``grad_clip_norm`` clips by the global norm of ALL gradients, frozen
  leaves included, before the optimizer; ``freeze_regex`` then zeroes the
  final update of frozen leaves (so adamw's decay does not move them). The
  regex is matched against the '/'-joined flax path (``tok_embed/
  embedding``, ``attn_0/query/kernel``), so one regex freezes the same
  leaves in both packages.
* ``Optimizer.state_dict()`` is optax's state tree of the chain
  ``_make_tx`` builds (``ScaleByAdamState(count, mu, nu)`` and the
  schedule's ``ScaleByScheduleState(count)``, ``TraceState`` for momentum,
  the ``EmptyState``s of sgd, adamw's decay, ``clip_by_global_norm`` and
  ``masked(set_to_zero)``), moments nested by flax path, counts int32, so
  either package resumes the other's checkpoint.

Steps on a mesh. The JAX package runs one global program per step. Here
every rank is handed the same global batch. A model inside a
``seq_attention_scope`` shards its activations itself
(``dl.backbones.SeqShard``); otherwise, on a ``data`` axis of 2 or more
ranks that divides the (micro)batch, each rank runs its own rows, and
BatchNorm takes its moments over the data axis (``layers.
batch_stats_over``), as the JAX package's global batch does. Each rank
scales its loss by 1/world before ``backward`` and one ``all_reduce_sum``
per step sums every gradient over the world, so every rank applies the
global gradient.

``param_sharding="zero"`` (alias ``"fsdp"``) keeps each parameter and its
moments at rest as this rank's block along the dimension the JAX
package's ``zero_sharding`` picks (``parallel.tree_shardings``; tensors
with no dimension divisible by the data axis stay whole). A step gathers
the blocks into the model over the data axis (one flat ``all_gather``),
runs forward and backward, sums the gradients with the replicated path's
flat ``all_reduce_sum`` and keeps this rank's slice, updates its blocks,
and drops the gathered parameters again. Without a mesh it runs
replicated (``stats["autoconfig"]``); a mesh without a ``data`` axis is
refused.

Batch statistics (JAX: ``model.apply(..., mutable=["batch_stats"])``). A
model's BatchNorm running statistics are buffers: a training forward
updates them in place, microbatch by microbatch under ``accum_steps``,
frozen leaves' statistics included; ``predict_logits`` and ``evaluate``
normalise with them. The optimizer and the all-reduce see parameters only.

Training state (``FlaxTrainer.fit``'s): with ``checkpoint_dir`` a
``core.checkpoint.CheckpointStore`` keeps the newest ``keep_checkpoints``
epoch checkpoints, one every ``save_every_epochs`` epochs, saved as epoch
``e + 1``: replicated state as one flax msgpack ``state.msgpack`` of
``{"params", "batch_stats", "opt_state", "epoch"}`` (byte for byte what
``flax.serialization.to_bytes`` writes for the same values), ZeRO state in
the sharded format of ``core.checkpoint.save_sharded_tree``. ``resume``
restarts from the newest checkpoint that verifies; ``preemption_point(
"dl.epoch", epoch)`` marks each epoch's start. ``nonfinite_policy``:
``"raise"`` stops, ``"skip"`` drops the step (parameters, moments and the
running statistics stay as they were before it), ``"rollback"`` restores
the last checkpoint and replays from its epoch. Batches come from
``np.random.default_rng([seed, epoch])`` with the epoch tail dropped, in the
JAX package's order, and dropout masks from a ``torch.Generator`` seeded
from ``(seed, step)`` (``(seed, step, i)`` for microbatch i), so a resumed
run replays the same batches and masks (the masks differ from flax's).
``_CHAOS_BATCH_HOOK``, when set, is called as ``hook(step, xb, yb)`` on each
host batch and returns the batch to train on.

``param_sharding="pipeline"`` runs ``dl.pipeline.fit_pipeline`` (a
``StageSequential`` model on a mesh with a ``stage`` axis; the
``pipeline_*`` fields set its microbatches, stage placement and schedule).

Elastic training: with a ``parallel.elastic_watchdog`` installed, each
step and its device sync run under the watchdog (``op="dl.step"``), and
each step beats ``"dl.step"``.

Not ported, and refused with ``NotImplementedError`` naming the setting:
any value but the default of ``prefetch_batches`` and ``donate_buffers``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import re
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import (CheckpointError, CheckpointStore,
                               LocalBlock, NonFiniteGuard,
                               NonFiniteLossError, load_sharded_from_checkpoint,
                               preemption_point, save_sharded_tree)
from ..core.device import DEFAULT_DEVICE, on_device_thread, resolve_device
from ..core.logging import record_failure
from ..core.serialization import from_bytes, to_bytes, to_state_dict
from ..parallel.collectives import all_gather, all_reduce_sum
from ..parallel.elastic import current_watchdog
from ..parallel.mesh import DATA_AXIS
from .layers import batch_stats_over

__all__ = ["NonFiniteLossError", "Optimizer", "TrainConfig", "Trainer",
           "freeze_mask", "softmax_np"]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MOMENTUM = 0.9

# called as hook(step, xb, yb) -> (xb, yb) on host batches before they reach
# the device (a NaN planted here reaches the loss as bad input data would)
_CHAOS_BATCH_HOOK = None

# optax's state types, by the names flax's msgpack files key them with
ScaleByAdamState = collections.namedtuple("ScaleByAdamState", "count mu nu")
TraceState = collections.namedtuple("TraceState", "trace")
ScaleByScheduleState = collections.namedtuple("ScaleByScheduleState", "count")
EmptyState = collections.namedtuple("EmptyState", "")
MaskedState = collections.namedtuple("MaskedState", "inner_state")


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` fields and defaults. The port has
    no input pipeline or buffer donation: the fields of those are kept so
    that ``Trainer.unported`` refuses any value but the default by name."""
    batch_size: int = 64
    max_epochs: int = 1
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    optimizer: str = "adam"            # adam | adamw | sgd | momentum
    lr_schedule: str = "constant"      # constant | cosine
    warmup_steps: int = 0
    grad_clip_norm: float = 0.0
    freeze_regex: Optional[str] = None  # param paths matching this are frozen
    compute_dtype: str = "float32"     # float32 | bfloat16
    seed: int = 0
    shuffle: bool = True
    steps_per_epoch: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    save_every_epochs: int = 1
    resume: bool = True
    keep_checkpoints: int = 3
    nonfinite_policy: str = "raise"
    param_sharding: str = "replicated"
    accum_steps: int = 1
    prefetch_batches: int = 2
    donate_buffers: bool = True
    pipeline_microbatches: int = 0
    pipeline_param_sharding: str = "replicated"
    pipeline_schedule: str = "fill_drain"
    seq_parallel: bool = True
    seq_attention: str = "auto"        # auto | ring | ulysses


# fields whose machinery the port does not have: only the default is taken
_UNPORTED_AT_DEFAULT = tuple(
    f for f in dataclasses.fields(TrainConfig)
    if f.name in ("prefetch_batches", "donate_buffers"))
_SHARDINGS = ("replicated", "zero", "fsdp", "pipeline", "auto")


def nest_sorted(flat: dict) -> dict:
    """A dict keyed by '/'-joined paths as nested dicts whose keys are
    sorted at every level (the order of a flax tree that came out of a
    ``jax.jit``)."""
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value

    def srt(d):
        return {k: srt(d[k]) if isinstance(d[k], dict) else d[k]
                for k in sorted(d)}
    return srt(tree)


def _flat_paths(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def freeze_mask(names: List[str], freeze_regex: Optional[str]
                ) -> Optional[Dict[str, bool]]:
    """{name: trainable} over parameter names (True = trainable), matching
    ``freeze_regex`` against each name's '/'-joined flax path; None without
    a regex."""
    if not freeze_regex:
        return None
    pat = re.compile(freeze_regex)
    return {n: not pat.search(n.replace(".", "/")) for n in names}


def _schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """optax's learning-rate schedule of ``_make_tx`` as a function of the
    update count (0 for the first update)."""
    lr = float(cfg.learning_rate)

    def warmup_cosine(init, peak, warmup, decay_steps, end=0.0):
        if not decay_steps - warmup > 0:
            raise ValueError("the cosine decay needs positive decay steps, "
                             f"got {decay_steps - warmup}")
        alpha = 0.0 if peak == 0.0 else end / peak

        def f(count):
            if count < warmup:
                c = min(max(count, 0), warmup)
                return (init - peak) * (1 - c / warmup) + peak
            c = min(count - warmup, decay_steps - warmup)
            cos = 0.5 * (1 + math.cos(math.pi * c / (decay_steps - warmup)))
            return peak * ((1 - alpha) * cos + alpha)
        return f

    if cfg.lr_schedule == "cosine":
        return warmup_cosine(0.0, lr, max(cfg.warmup_steps, 1),
                             max(total_steps, cfg.warmup_steps + 1))
    if cfg.warmup_steps == 0:
        return lambda count: lr
    return warmup_cosine(0.0, lr, cfg.warmup_steps, total_steps, lr)


class Optimizer:
    """The update rule of the JAX package's ``_make_tx`` on a list of named
    float32 parameters (or, under ZeRO, this rank's blocks of them),
    updated in place by ``step(grads)``."""

    def __init__(self, cfg: TrainConfig, total_steps: int,
                 named_params: List[Tuple[str, torch.Tensor]]):
        if cfg.optimizer not in ("adam", "adamw", "sgd", "momentum"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.kind = cfg.optimizer
        self.weight_decay = float(cfg.weight_decay)
        self.clip = float(cfg.grad_clip_norm)
        self.masked = bool(cfg.freeze_regex)
        self.schedule = _schedule(cfg, total_steps)
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        mask = freeze_mask(self.names, cfg.freeze_regex)
        self.trainable = [True] * len(self.names) if mask is None else \
            [mask[n] for n in self.names]
        self.count = 0
        # the whole tensors' shapes (the Trainer sets them under ZeRO, where
        # ``params`` are this rank's blocks)
        self.whole_shapes = [tuple(p.shape) for p in self.params]
        adam = self.kind in ("adam", "adamw")
        # first moment (adam) or trace (momentum); second moment (adam)
        self.mu = [torch.zeros_like(p) for p in self.params] \
            if adam or self.kind == "momentum" else None
        self.nu = [torch.zeros_like(p) for p in self.params] if adam else None

    def updates(self, grads: List[torch.Tensor],
                g_norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """The updates of this step (advancing the optimizer's state).
        ``g_norm`` is the global gradient norm for the clip when ``grads``
        are blocks of the whole gradients (ZeRO)."""
        if self.clip > 0:
            if g_norm is None:
                g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if not bool(g_norm < self.clip):
                grads = [(g / g_norm) * self.clip for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        out = []
        for i, g in enumerate(grads):
            if self.kind in ("adam", "adamw"):
                self.mu[i] = (1 - ADAM_B1) * g + ADAM_B1 * self.mu[i]
                self.nu[i] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu[i]
                mu_hat = self.mu[i] / self._bias_correction(ADAM_B1, g)
                nu_hat = self.nu[i] / self._bias_correction(ADAM_B2, g)
                u = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
                if self.kind == "adamw":
                    u = u + self.weight_decay * self.params[i]
            elif self.kind == "momentum":
                self.mu[i] = g + MOMENTUM * self.mu[i]
                u = self.mu[i]
            else:
                u = g
            u = -lr * u
            out.append(u if self.trainable[i] else torch.zeros_like(u))
        return out

    def _bias_correction(self, decay: float, like: torch.Tensor):
        """``1 - decay ** count`` in float32, as optax computes it (the
        float32 rounding of 0.999 alone moves ``1 - 0.999`` by 1.3e-5
        relative), as a 0-d tensor on ``like``'s device: a true division,
        where a Python scalar divisor may become a reciprocal product."""
        bc = np.float32(1) - np.float32(decay) ** np.float32(self.count)
        return torch.tensor(bc, dtype=torch.float32, device=like.device)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             g_norm: Optional[torch.Tensor] = None) -> None:
        for p, u in zip(self.params, self.updates(grads, g_norm)):
            p.add_(u)

    # --- optax's state tree ---------------------------------------------
    def state_dict(self, leaf: Optional[Callable] = None):
        """optax's state of ``_make_tx``'s chain for these parameters:
        tuples and optax's namedtuples, moments as nested dicts by flax
        path (keys sorted), each count an int32 0-d tensor. ``leaf(i, t)``
        replaces moment ``t`` of parameter ``i`` (default: the tensor)."""
        leaf = leaf or (lambda i, t: t)

        def tree(ts):
            return nest_sorted({n.replace(".", "/"): leaf(i, t) for i, (n, t)
                                in enumerate(zip(self.names, ts))})

        count = torch.tensor(self.count, dtype=torch.int32)
        if self.kind in ("adam", "adamw"):
            first = ScaleByAdamState(count, tree(self.mu), tree(self.nu))
        elif self.kind == "momentum":
            first = TraceState(tree(self.mu))
        else:
            first = EmptyState()
        core = (first,) + ((EmptyState(),) if self.kind == "adamw" else ()) \
            + (ScaleByScheduleState(count.clone()),)
        if self.clip > 0:
            core = (EmptyState(), core)
        if self.masked:
            core = (core, MaskedState(EmptyState()))
        return core

    def template(self, whole: bool = False):
        """``state_dict()``'s structure with meta tensors (shapes and dtypes
        only): of this rank's tensors, or ``whole`` of the whole ones."""
        shapes = self.whole_shapes if whole else \
            [tuple(p.shape) for p in self.params]
        return self.state_dict(lambda i, t: torch.empty(
            shapes[i], dtype=t.dtype, device="meta"))

    @torch.no_grad()
    def load_state_dict(self, state, take: Optional[Callable] = None) -> None:
        """Load optax's state (this layout as namedtuples, or its flax state
        dict) for these parameters; ``take(i, t)`` cuts parameter ``i``'s
        moment from a whole tensor ``t`` (ZeRO loading a replicated
        checkpoint). Names, shapes and dtypes are checked."""
        from ..core.serialization import from_state_dict

        st = from_state_dict(self.template(whole=take is not None),
                             to_state_dict(state))
        core = st[0] if self.masked else st
        core = core[1] if self.clip > 0 else core
        counts = {int(core[-1].count)}
        first = core[0]
        if self.kind in ("adam", "adamw"):
            counts.add(int(first.count))
        if len(counts) != 1:
            raise ValueError(f"optimizer state counts disagree: {counts}")
        self.count = counts.pop()

        def load(tree):
            flat = _flat_paths(tree)
            out = []
            for i, n in enumerate(self.names):
                t = flat[n.replace(".", "/")]
                t = t if take is None else take(i, t)
                out.append(t.to(self.params[i].device).clone())
            return out
        if self.kind in ("adam", "adamw"):
            self.mu, self.nu = load(first.mu), load(first.nu)
        elif self.kind == "momentum":
            self.mu = load(first.trace)


def _step_seed(*key: int) -> int:
    """A 63-bit torch seed from (seed, step[, microbatch])."""
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1])) & (2 ** 63 - 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Counterpart of the JAX package's ``FlaxTrainer``: the supervised
    fine-tune loop of a ``torch.nn.Module`` whose ``forward(x, train,
    generator)`` returns logits, with softmax cross-entropy loss (the JAX
    package's ``loss="mse"`` waits for a ported regressor). With a
    ``parallel.Mesh`` carrying a ``seq`` axis of 2 or more ranks (and
    ``seq_parallel``), the fit's forwards run inside a
    ``seq_attention_scope`` of the resolved variant; scoring runs there too
    (the JAX package scores outside it; the values agree within the
    sharded attention's tolerance). Every rank of the mesh calls ``fit``
    and ``predict_logits`` with the same arguments.

    ``step_stats`` holds each applied step's loss, seconds (parameter
    gather under ZeRO, forward, backward, gradient all-reduce, update; the
    card synchronised at each boundary) and ``grad_norms``, the L2 norm of
    each parameter's gradient after the all-reduce (what the step
    applies), by parameter name. ``stats["state_bytes_per_rank"]`` counts
    the parameters and optimizer state one rank holds at rest, from the
    shard specs (``per_device_state_bytes`` of the JAX package)."""

    def __init__(self, model: nn.Module, config: TrainConfig, mesh=None,
                 device=DEFAULT_DEVICE):
        self.model = model
        self.cfg = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model.to(self.device)
        self.history: List[dict] = []
        self.step_stats: List[dict] = []
        self.stats: dict = {}
        self.optimizer: Optional[Optimizer] = None
        self.specs: Optional[List] = None
        self._seq_variant = None
        self._pending_opt_state = None

    # --- setup ----------------------------------------------------------
    def init(self, sample_x=None) -> "Trainer":
        """Draw the model's parameters anew from ``cfg.seed`` (every module
        with a ``reset_parameters``, in ``model.modules()`` order, on a
        forked CPU generator): the same parameters on every rank. The
        values differ from flax's ``init`` (only the distributions are
        flax's); ``sample_x`` is accepted for the JAX signature."""
        with torch.random.fork_rng(devices=[]):
            torch.random.default_generator.manual_seed(int(self.cfg.seed))
            cpu = self.model.to("cpu")
            for m in cpu.modules():
                if hasattr(m, "reset_parameters"):
                    m.reset_parameters()
        self.model.to(self.device)
        return self

    def load_params(self, params, batch_stats=None,
                    opt_state=None) -> "Trainer":
        """Load ``params`` (a ``state_dict``: every parameter, and buffers
        where it holds them) and ``batch_stats`` (buffers by name), as
        ``FlaxTrainer.load_params``: buffers given in neither keep their
        values. Names and shapes are checked. ``opt_state`` (optax's state
        tree, e.g. from ``convert.trainer_state_from_reference``) is loaded
        into the optimizer the next ``fit`` builds."""
        sd = {**dict(params), **dict(batch_stats or {})}
        for name, buf in self.model.named_buffers():
            sd.setdefault(name, buf)
        self.model.load_state_dict(sd)
        self.model.to(self.device)
        self._pending_opt_state = opt_state
        return self

    @staticmethod
    def unported(cfg: TrainConfig) -> List[str]:
        """``name=value`` of every setting the port does not implement."""
        out = []
        for f in _UNPORTED_AT_DEFAULT:
            v = getattr(cfg, f.name)
            if v != f.default:
                out.append(f"{f.name}={v!r}")
        return out

    def _world(self) -> int:
        if self.mesh is None:
            return 1
        return int(np.prod(list(self.mesh.shape.values())))

    # --- data -----------------------------------------------------------
    def _batches(self, X, y, rng: np.random.Generator
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Shuffled fixed-size batches, the epoch tail dropped (a dataset
        smaller than one batch trains on all its rows each step)."""
        n = len(X)
        if n == 0:
            raise ValueError("cannot train on an empty dataset")
        idx = rng.permutation(n) if self.cfg.shuffle else np.arange(n)
        bs = self.cfg.batch_size
        if n < bs:
            yield X[idx], y[idx]
            return
        limit = self.cfg.steps_per_epoch
        for s, start in enumerate(range(0, n - bs + 1, bs)):
            if limit and s >= limit:
                return
            sel = idx[start: start + bs]
            yield X[sel], y[sel]

    # --- sequence parallelism ------------------------------------------
    def _resolve_seq_attention(self, X):
        """(scope, provenance): the ``seq_attention_scope`` of the variant
        for this fit, or a null context without a ``seq`` axis of 2+ ranks
        or with ``seq_parallel=False``. An explicit "ring"/"ulysses" wins;
        "auto" asks ``core.perfmodel.suggest_seq_attention``."""
        from ..parallel.mesh import SEQ_AXIS
        from .backbones import seq_attention_scope

        cfg = self.cfg
        if cfg.seq_attention not in ("auto", "ring", "ulysses"):
            from ..parallel.elastic import ElasticUnsupportedError
            from .pipeline import SUPPORTED_MATRIX

            raise ElasticUnsupportedError(
                f"seq attention variant {cfg.seq_attention!r}",
                matrix=SUPPORTED_MATRIX,
                hint="seq_attention must be one of: auto | ring | ulysses")
        self._seq_variant = None
        sp = int(self.mesh.shape.get(SEQ_AXIS, 1)) if self.mesh else 1
        if not cfg.seq_parallel or sp < 2:
            return contextlib.nullcontext(), {}
        variant = cfg.seq_attention
        if variant == "auto":
            from ..core.perfmodel import suggest_seq_attention

            variant, info = suggest_seq_attention(
                _attention_heads(self.model) or sp, sp)
        else:
            info = {"arm": variant, "source": "explicit",
                    "fallback_used": False}
        self._seq_variant = variant
        return seq_attention_scope(self.mesh, variant), {"seq_attention": info}

    def _scope(self):
        from .backbones import seq_attention_scope

        if self._seq_variant is None:
            return contextlib.nullcontext()
        return seq_attention_scope(self.mesh, self._seq_variant)

    # --- parameter placement ---------------------------------------------
    def _resolve_sharding(self, autoconfig: dict) -> bool:
        """Whether this fit runs ZeRO; records fallbacks in ``autoconfig``."""
        mode = self.cfg.param_sharding
        if mode not in _SHARDINGS:
            raise ValueError(f"unknown param_sharding {mode!r}; expected "
                             "replicated | zero | fsdp | pipeline | auto")
        if mode == "auto":
            autoconfig["param_sharding"] = {"arm": "replicated",
                                            "source": "fallback"}
            return False
        if mode in ("zero", "fsdp"):
            if self.mesh is None:
                autoconfig["param_sharding"] = {"arm": "replicated",
                                                "source": "no mesh"}
                return False
            if DATA_AXIS not in self.mesh.shape:
                raise ValueError(
                    f"param_sharding={mode!r} shards over the mesh's "
                    f"{DATA_AXIS!r} axis; the mesh {self.mesh.shape} has none")
            return True
        return False

    def _setup_state(self, total_steps: int, zero: bool) -> None:
        """The optimizer over the parameters, or under ZeRO over this
        rank's blocks of them (the model's sharded parameters are then
        dropped until a step gathers them)."""
        from ..parallel.mesh import tree_shardings

        named = list(self.model.named_parameters())
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        if zero:
            specs = tree_shardings(self.mesh, named, "zero")
            self.specs = [specs[n] for n in self._names]
            self._dp = int(self.mesh.shape[DATA_AXIS])
            self._dp_index = self.mesh.axis_index(DATA_AXIS)
            blocks = [(n, s.take(p.detach(), self._dp_index).clone()
                       if s.dim is not None else p.detach())
                      for (n, p), s in zip(named, self.specs)]
            opt = Optimizer(self.cfg, total_steps, blocks)
            opt.whole_shapes = [tuple(p.shape) for p in self._params]
        else:
            self.specs = None
            opt = Optimizer(self.cfg, total_steps, named)
        self.optimizer = opt
        if self._pending_opt_state is not None:
            opt.load_state_dict(self._pending_opt_state,
                                take=self._take if zero else None)
            self._pending_opt_state = None
        self._release_params()

    def _take(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of parameter ``i``'s whole tensor ``t``."""
        return self.specs[i].take(t, self._dp_index)

    def _sharded(self) -> List[int]:
        return [] if self.specs is None else \
            [i for i, s in enumerate(self.specs) if s.dim is not None]

    @torch.no_grad()
    def _gather_params(self) -> None:
        """Every sharded parameter whole in the model: one flat
        ``all_gather`` of this rank's blocks over the data axis."""
        idx = self._sharded()
        if not idx:
            return
        blocks = [self.optimizer.params[i] for i in idx]
        flat = torch.cat([b.reshape(-1) for b in blocks])
        parts = all_gather(flat, self.mesh.group(DATA_AXIS), axis=0) \
            .view(self._dp, -1)
        off = 0
        for i, b in zip(idx, blocks):
            k = b.numel()
            self._params[i].data = torch.cat(
                [parts[r, off: off + k].view(b.shape)
                 for r in range(self._dp)], dim=self.specs[i].dim)
            off += k

    def _release_params(self) -> None:
        """Drop the gathered copies of the sharded parameters."""
        for i in self._sharded():
            p = self._params[i]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def state_bytes_per_rank(self) -> int:
        """Bytes of parameters and optimizer state one rank holds at rest
        (this rank's blocks under ZeRO)."""
        opt = self.optimizer
        moments = sum(m is not None for m in (opt.mu, opt.nu))
        counts = 2 if opt.kind in ("adam", "adamw") else 1
        total = 0
        for i, shape in enumerate(opt.whole_shapes):
            numel = int(np.prod(shape))
            if self.specs is not None:
                numel = self.specs[i].shard_numel(shape)
            total += numel * opt.params[i].element_size() * (1 + moments)
        return total + 4 * counts

    # --- training state ---------------------------------------------------
    def _state(self, leaf=None) -> dict:
        """``{"params", "batch_stats", "opt_state"}`` as the JAX trainer's
        tree; ``leaf(i, t)`` makes the leaf of parameter ``i``'s tensor
        ``t`` (its block under ZeRO, for params and moments alike)."""
        opt = self.optimizer
        leaf = leaf or (lambda i, t: t)
        params = nest_sorted({n.replace(".", "/"): leaf(i, opt.params[i])
                              for i, n in enumerate(self._names)})
        stats = nest_sorted({n.replace(".", "/"): b for n, b in
                             self.model.named_buffers()})
        return {"params": params, "batch_stats": stats,
                "opt_state": opt.state_dict(leaf)}

    def _block(self, i: int, t: torch.Tensor):
        """Parameter ``i``'s tensor as a sharded checkpoint leaf: the whole
        tensor, or this rank's ``LocalBlock`` of it."""
        if self.specs is None or self.specs[i].dim is None:
            return t
        shape = self.optimizer.whole_shapes[i]
        owner = all(c == 0 for a, c in self.mesh.coords.items()
                    if a != DATA_AXIS)
        return LocalBlock(t, shape, self.specs[i].window(shape,
                                                         self._dp_index),
                          owner)

    def state_tree(self) -> dict:
        """The training state as the JAX trainer's ``{"params",
        "batch_stats", "opt_state"}`` tree of whole CPU tensors (under
        ZeRO each block is gathered over the data axis: every rank calls
        it)."""
        def whole(i, t):
            if self.specs is None or self.specs[i].dim is None:
                return t
            return self._gather_one(t, i)
        return _map_tensors(self._state(whole),
                            lambda t: t.detach().cpu().clone())

    @torch.no_grad()
    def _gather_one(self, block: torch.Tensor, i: int) -> torch.Tensor:
        parts = all_gather(block.reshape(-1).contiguous(),
                           self.mesh.group(DATA_AXIS), axis=0)
        return torch.cat(list(parts.view(self._dp, *block.shape)),
                         dim=self.specs[i].dim)

    def _save_checkpoint(self, store: CheckpointStore, epoch: int) -> None:
        """The epoch checkpoint (``FlaxTrainer``'s ``_save_checkpoint``):
        one ``state.msgpack`` written by rank 0, or under ZeRO the sharded
        format with every rank's blocks."""
        meta = {"kind": "dl-trainer", "epoch": int(epoch)}
        if self.specs is not None:
            save_sharded_tree(store, epoch, self._state(self._block),
                              meta=dict(meta, format="sharded"),
                              group=self.mesh.world_group)
            return
        if self.mesh is None or self.mesh.rank == 0:
            blob = to_bytes({**self._state(), "epoch": int(epoch)})
            store.save(epoch, {"state.msgpack": blob}, meta=meta)
        if self._world() > 1:
            torch.distributed.barrier(group=self.mesh.world_group)

    def _restore_checkpoint(self, store: CheckpointStore) -> Optional[int]:
        """Load the newest verified checkpoint and return its epoch, or None
        when the store holds none. A checkpoint of another structure raises
        a ValueError naming ``resume=False``."""
        ckpt = store.load_latest(artifact_filter=lambda n: n in (
            "state.msgpack", "state.sharding.json"))
        if ckpt is None:
            return None
        sharded = "state.sharding.json" in ckpt.artifacts
        if not sharded and "state.msgpack" not in ckpt.artifacts:
            record_failure("checkpoint.pytree_mismatch", base=ckpt.base,
                           reason="missing state.msgpack artifact")
            raise ValueError(
                f"checkpoint {ckpt.base} in {store.dir} has no trainer state "
                "artifact; point checkpoint_dir at a fresh directory")
        opt = self.optimizer
        try:
            if sharded:
                template = self._state(lambda i, t: self._block(
                    i, torch.empty(t.shape, dtype=t.dtype, device="meta")))
                tree = load_sharded_from_checkpoint(store, ckpt, template)
                self._load_state(tree, whole=False)
                return int(ckpt.meta.get("epoch", ckpt.step))
            template = self._state(lambda i, t: torch.empty(
                opt.whole_shapes[i], dtype=t.dtype, device="meta"))
            template = _map_tensors(template, lambda t: torch.empty(
                t.shape, dtype=t.dtype, device="meta"))
            tree = from_bytes({**template, "epoch": 0},
                              ckpt.artifacts["state.msgpack"])
            self._load_state(tree, whole=True)
            return int(tree["epoch"])
        except (CheckpointError, ValueError, KeyError) as e:
            record_failure("checkpoint.pytree_mismatch", base=ckpt.base,
                           error=str(e)[:200])
            raise ValueError(
                f"checkpoint {ckpt.base} in {store.dir} does not match the "
                "current model/optimizer structure (architecture or "
                f"optimizer changed since it was saved): {e}. Delete the "
                "checkpoint directory or set resume=False to train from "
                "scratch") from e

    @torch.no_grad()
    def _load_state(self, tree: dict, whole: bool) -> None:
        """Load a restored ``{"params", "batch_stats", "opt_state"}`` of CPU
        tensors: whole tensors (``whole``) or this rank's blocks."""
        opt = self.optimizer
        take = self._take if (whole and self.specs is not None) else None
        flat = _flat_paths(tree["params"])
        for i, n in enumerate(self._names):
            t = flat[n.replace(".", "/")]
            opt.params[i].copy_(take(i, t) if take else t)
        stats = _flat_paths(tree["batch_stats"])
        for n, b in self.model.named_buffers():
            b.copy_(stats[n.replace(".", "/")])
        opt.load_state_dict(tree["opt_state"], take=take)

    # --- train ----------------------------------------------------------
    def _input(self, xb) -> torch.Tensor:
        """A batch on the device; float inputs in the compute dtype, token
        ids left integral (as the JAX package's ``cast_in``)."""
        x = torch.as_tensor(xb, device=self.device)
        if x.is_floating_point() and self.cfg.compute_dtype == "bfloat16":
            x = x.to(torch.bfloat16)
        return x

    def fit(self, X, y, valid: Optional[tuple] = None,
            log_fn: Optional[Callable] = None) -> "Trainer":
        cfg = self.cfg
        bad = self.unported(cfg)
        if bad:
            raise NotImplementedError(
                "not ported to the PyTorch package yet: " + ", ".join(bad))
        if cfg.param_sharding == "pipeline":
            from .pipeline import fit_pipeline

            _scope, self._seq_autoconfig = self._resolve_seq_attention(X)
            return fit_pipeline(self, X, y, valid=valid, log_fn=log_fn)
        autoconfig: dict = {}
        zero = self._resolve_sharding(autoconfig)
        accum = max(int(cfg.accum_steps), 1)
        if int(cfg.accum_steps) == 0:
            autoconfig["accum_steps"] = {"arm": 1, "source": "fallback"}
        if cfg.batch_size % accum:
            raise ValueError(f"accum_steps={accum} must divide "
                             f"batch_size={cfg.batch_size}")
        guard = NonFiniteGuard(policy=cfg.nonfinite_policy,
                               counter_prefix="train")
        X, y = np.asarray(X), np.asarray(y)
        scope, seq_info = self._resolve_seq_attention(X)
        autoconfig.update(seq_info)
        n = len(X)
        steps_per_epoch = cfg.steps_per_epoch or max(n // cfg.batch_size, 1)
        total_steps = steps_per_epoch * cfg.max_epochs
        self._setup_state(total_steps, zero)
        store = (CheckpointStore(cfg.checkpoint_dir,
                                 keep_last=max(cfg.keep_checkpoints, 1))
                 if cfg.checkpoint_dir else None)
        epoch = step_idx = 0
        if store is not None and cfg.resume:
            restored = self._restore_checkpoint(store)
            if restored is not None:
                epoch, step_idx = restored, restored * steps_per_epoch
        self.stats = {"state_bytes_per_rank": self.state_bytes_per_rank()}
        if self._seq_variant:
            self.stats["seq_attention"] = self._seq_variant
        if autoconfig:
            self.stats["autoconfig"] = autoconfig
        self.model.train()
        history = []
        with scope:
            while epoch < cfg.max_epochs:
                preemption_point("dl.epoch", epoch)
                rng_e = np.random.default_rng([cfg.seed, epoch])
                losses, t0, rolled_back = [], time.perf_counter(), False
                for i, (xb, yb) in enumerate(self._batches(X, y, rng_e)):
                    hook = _CHAOS_BATCH_HOOK
                    if hook is not None:
                        xb, yb = hook(epoch * steps_per_epoch + i, xb, yb)
                    wd = current_watchdog()
                    if wd is not None:
                        # the step and its device sync under the stall
                        # guard: a lost peer surfaces as PeerLostError
                        loss, action = wd.run(
                            on_device_thread(self.device, self._step), xb,
                            yb, step_idx, accum, guard, op="dl.step")
                        wd.beat("dl.step", step_idx)
                    else:
                        loss, action = self._step(xb, yb, step_idx, accum,
                                                  guard)
                    if action == "rollback":
                        restored = (self._restore_checkpoint(store)
                                    if store is not None else None)
                        if restored is None:
                            raise NonFiniteLossError(
                                "nonfinite_policy='rollback' found no "
                                "checkpoint to restore (set checkpoint_dir "
                                "and let at least one epoch complete, or use "
                                "policy 'skip'/'raise')")
                        epoch, step_idx = restored, \
                            restored * steps_per_epoch
                        rolled_back = True
                        break
                    step_idx += 1
                    if action == "ok":
                        losses.append(loss)
                if rolled_back:
                    continue
                ep = {"epoch": epoch,
                      "loss": float(np.mean(losses)) if losses
                      else float("nan"),
                      "steps": len(losses),
                      "seconds": time.perf_counter() - t0}
                if valid is not None:
                    ep["val_acc"] = self.evaluate(valid[0], valid[1])
                    self.model.train()
                history.append(ep)
                if log_fn:
                    log_fn(ep)
                if store is not None and \
                        (epoch + 1) % cfg.save_every_epochs == 0:
                    self._save_checkpoint(store, epoch + 1)
                epoch += 1
        self._gather_params()
        self.model.eval()
        self.history = history
        return self

    def _split_rows(self, rows: int):
        """(this rank's row slice, data group) when the step runs the data
        axis's ranks on their own rows, else (None, None)."""
        if self.mesh is None or self._seq_variant is not None:
            return None, None
        dp = int(self.mesh.shape.get(DATA_AXIS, 1))
        if dp < 2 or rows % dp:
            return None, None
        b, j = rows // dp, self.mesh.axis_index(DATA_AXIS)
        return slice(j * b, (j + 1) * b), self.mesh.group(DATA_AXIS)

    def _step(self, xb, yb, step_idx: int, accum: int,
              guard: NonFiniteGuard) -> Tuple[float, str]:
        """One step: (its loss, the guard's action). A step the guard drops
        leaves parameters, moments and running statistics as they were."""
        cfg, dev, world = self.cfg, self.device, self._world()
        params, opt = self._params, self.optimizer
        xs = np.split(xb, accum) if accum > 1 else [xb]
        ys = np.split(yb, accum) if accum > 1 else [yb]
        rows, group = self._split_rows(len(xs[0]))
        buffers = [b.detach().clone() for b in self.model.buffers()] \
            if cfg.nonfinite_policy == "skip" else None
        t = {"gather_s": 0.0, "forward_s": 0.0, "backward_s": 0.0}
        t0 = time.perf_counter()
        self._gather_params()
        _sync(dev)
        t["gather_s"] = time.perf_counter() - t0
        for p in params:
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float64)
        for i, (xm, ym) in enumerate(zip(xs, ys)):
            if rows is not None:
                xm, ym = xm[rows], ym[rows]
            key = (cfg.seed, step_idx) if accum == 1 else \
                (cfg.seed, step_idx, i)
            gen = torch.Generator(device=dev)
            gen.manual_seed(_step_seed(*key))
            t0 = time.perf_counter()
            with batch_stats_over(group):
                logits = self.model(self._input(xm), train=True,
                                    generator=gen)
            loss = F.cross_entropy(logits.float(),
                                   torch.as_tensor(ym, device=dev).long())
            _sync(dev)
            t1 = time.perf_counter()
            with batch_stats_over(group):
                (loss / (accum * world)).backward()
            _sync(dev)
            t["forward_s"] += t1 - t0
            t["backward_s"] += time.perf_counter() - t1
            loss_sum += float(loss.detach())
        if group is not None:
            loss_sum = all_reduce_sum(loss_sum, group) / \
                torch.distributed.get_world_size(group)
        loss_val = float(loss_sum) / accum
        action = guard.check(loss_val, step_idx)
        if action != "ok":
            if buffers is not None:
                with torch.no_grad():
                    for b, saved in zip(self.model.buffers(), buffers):
                        b.copy_(saved)
            for p in params:
                p.grad = None
            self._release_params()
            return loss_val, action
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        t0 = time.perf_counter()
        if world > 1:
            flat = torch.cat([g.reshape(-1) for g in grads])
            all_reduce_sum(flat, self.mesh.world_group)
            grads = [g.view_as(p) for g, p in
                     zip(flat.split([p.numel() for p in params]), params)]
        _sync(dev)
        t1 = time.perf_counter()
        norms = torch.stack([g.norm() for g in grads])
        g_norm = None
        if self.specs is not None:
            if opt.clip > 0:
                g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            grads = [self._take(i, g) for i, g in enumerate(grads)]
        opt.step(grads, g_norm)
        for p in params:
            p.grad = None
        self._release_params()
        _sync(dev)
        t.update(allreduce_s=t1 - t0, update_s=time.perf_counter() - t1,
                 loss=loss_val, step=step_idx)
        t["grad_norms"] = dict(zip(self._names, norms.tolist()))
        self.step_stats.append(t)
        return loss_val, action

    # --- eval / predict ---------------------------------------------------
    @torch.no_grad()
    def predict_logits(self, X, batch_size: Optional[int] = None
                       ) -> np.ndarray:
        """float32 logits of ``X`` in batches of ``batch_size`` (default the
        config's); the tail batch is padded with copies of its last row, as
        the JAX package pads it, and the padding cut off."""
        bs = batch_size or self.cfg.batch_size
        X = np.asarray(X)
        self._gather_params()
        self.model.eval()

        def fwd(xb):
            return self.model(torch.as_tensor(xb, device=self.device),
                              train=False).float().cpu().numpy()

        with self._scope():
            if len(X) == 0:
                return fwd(np.zeros((1,) + X.shape[1:], X.dtype))[:0]
            outs = []
            for start in range(0, len(X), bs):
                xb = X[start: start + bs]
                pad = 0
                if len(xb) < bs and outs:
                    pad = bs - len(xb)
                    xb = np.concatenate([xb, np.repeat(xb[-1:], pad, axis=0)])
                o = fwd(xb)
                outs.append(o[: len(o) - pad] if pad else o)
        return np.concatenate(outs)

    def evaluate(self, X, y) -> float:
        logits = self.predict_logits(X)
        return float((logits.argmax(-1) == np.asarray(y)).mean())


def _map_tensors(tree, fn):
    """``tree`` (dicts, tuples, namedtuples) with ``fn`` applied to every
    tensor leaf."""
    from ..core.checkpoint import tree_flatten_with_path, tree_unflatten

    leaves = [fn(v) if isinstance(v, torch.Tensor) else v
              for _, v in tree_flatten_with_path(tree)]
    return tree_unflatten(tree, leaves)


def _attention_heads(model: nn.Module) -> int:
    """The head count of the model's first attention, or 0."""
    for m in model.modules():
        if hasattr(m, "num_heads") and hasattr(m, "dropout_rate"):
            return int(m.num_heads)
    return 0


def softmax_np(logits: np.ndarray) -> np.ndarray:
    """Numerically stable softmax on host arrays."""
    z = logits - logits.max(-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(-1, keepdims=True)
