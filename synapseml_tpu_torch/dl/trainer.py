"""The supervised fine-tune loop of the text estimators.

Counterpart of the JAX package's ``dl/trainer.py``: ``TrainConfig`` with its
fields and defaults, the optimizers of ``_make_tx``, ``freeze_mask`` and
``Trainer``, the counterpart of ``FlaxTrainer`` for the configurations the
port runs (replicated parameters, with or without a ``seq`` mesh axis).

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

Steps on a mesh. The JAX package runs one global program per step. Here
every rank runs the model on the same global batch and gets the same
global logits (``dl.backbones.SeqShard``), so each rank scales its loss by
1/world before ``backward`` (``all_gather``'s backward sums the shards'
cotangents), and one ``all_reduce_sum`` per step sums every gradient over
the world. The replicated part (final LayerNorm and head) and the
shard-local part then both hold the global gradient, and the parameters
stay bitwise equal on every rank.

Batch statistics (JAX: ``model.apply(..., mutable=["batch_stats"])``). A
model's BatchNorm running statistics are buffers: a training forward
updates them in place, microbatch by microbatch under ``accum_steps`` (the
carry of the JAX package's ``scan``), frozen leaves' statistics included
(``freeze_regex`` masks only the optimizer's update); ``predict_logits``
and ``evaluate`` normalise with them. The optimizer, the gradient norms
and the all-reduce see parameters only. A model with BatchNorm on a mesh
of more than one rank is refused: the JAX package normalises over the
global batch there, and per-rank statistics would differ.

Batches come from ``np.random.default_rng([seed, epoch])`` with the epoch
tail dropped, in the JAX package's order. Dropout masks are drawn from a
``torch.Generator`` seeded from ``(seed, step)`` (``(seed, step, i)`` for
microbatch i), the counterpart of ``fold_in(PRNGKey(seed), step)``; the
masks differ from flax's. Not ported, and refused with
``NotImplementedError`` naming the setting: ``param_sharding`` other than
``"replicated"`` (``"auto"`` resolves to it), ``checkpoint_dir`` and
``nonfinite_policy`` ``"skip"``/``"rollback"``.
"""

from __future__ import annotations

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

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..parallel.collectives import all_reduce_sum
from .layers import BatchNorm

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MOMENTUM = 0.9


class NonFiniteLossError(FloatingPointError):
    """A training step's loss was NaN or infinite (``nonfinite_policy``
    "raise")."""


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` fields and defaults. The port runs
    the replicated configuration without a checkpoint store, an input
    pipeline, buffer donation or pipeline parallelism: the fields of those
    are kept so that ``Trainer.unported`` refuses any value but the default
    by name (``resume`` is inert while ``checkpoint_dir`` is refused)."""
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
    if f.name in ("save_every_epochs", "keep_checkpoints", "prefetch_batches",
                  "donate_buffers", "pipeline_microbatches",
                  "pipeline_param_sharding", "pipeline_schedule"))


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
    float32 parameters, updated in place by ``step(grads)``."""

    def __init__(self, cfg: TrainConfig, total_steps: int,
                 named_params: List[Tuple[str, torch.Tensor]]):
        if cfg.optimizer not in ("adam", "adamw", "sgd", "momentum"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.kind = cfg.optimizer
        self.weight_decay = float(cfg.weight_decay)
        self.clip = float(cfg.grad_clip_norm)
        self.schedule = _schedule(cfg, total_steps)
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        mask = freeze_mask(self.names, cfg.freeze_regex)
        self.trainable = [True] * len(self.names) if mask is None else \
            [mask[n] for n in self.names]
        self.count = 0
        adam = self.kind in ("adam", "adamw")
        # first moment (adam) or trace (momentum); second moment (adam)
        self.mu = [torch.zeros_like(p) for p in self.params] \
            if adam or self.kind == "momentum" else None
        self.nu = [torch.zeros_like(p) for p in self.params] if adam else None

    def updates(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The updates of this step (advancing the optimizer's state)."""
        if self.clip > 0:
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
    def step(self, grads: List[torch.Tensor]) -> None:
        for p, u in zip(self.params, self.updates(grads)):
            p.add_(u)


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

    ``step_stats`` holds each step's loss, seconds (forward, backward,
    gradient all-reduce, update; the card synchronised at each boundary)
    and ``grad_norms``, the L2 norm of each parameter's gradient after the
    all-reduce (what the step applies), by parameter name."""

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
        self._seq_variant = None

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

    def load_params(self, params, batch_stats=None) -> "Trainer":
        """Load ``params`` (a ``state_dict``: every parameter, and buffers
        where it holds them) and ``batch_stats`` (buffers by name), as
        ``FlaxTrainer.load_params``: buffers given in neither keep their
        values. Names and shapes are checked."""
        sd = {**dict(params), **dict(batch_stats or {})}
        for name, buf in self.model.named_buffers():
            sd.setdefault(name, buf)
        self.model.load_state_dict(sd)
        self.model.to(self.device)
        return self

    @staticmethod
    def unported(cfg: TrainConfig) -> List[str]:
        """``name=value`` of every setting the port does not implement."""
        out = []
        if cfg.param_sharding not in ("replicated", "auto"):
            out.append(f"param_sharding={cfg.param_sharding!r}")
        if cfg.checkpoint_dir:
            out.append(f"checkpoint_dir={cfg.checkpoint_dir!r}")
        if cfg.nonfinite_policy != "raise":
            out.append(f"nonfinite_policy={cfg.nonfinite_policy!r}")
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
            raise ValueError(f"seq attention variant {cfg.seq_attention!r}: "
                             "expected auto | ring | ulysses")
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
                "not ported to the PyTorch package yet: " + ", ".join(bad)
                + " (the port trains replicated parameters without "
                "checkpoints)")
        autoconfig = {}
        if cfg.param_sharding == "auto":
            autoconfig["param_sharding"] = {"arm": "replicated",
                                            "source": "fallback"}
        accum = max(int(cfg.accum_steps), 1)
        if int(cfg.accum_steps) == 0:
            autoconfig["accum_steps"] = {"arm": 1, "source": "fallback"}
        if cfg.batch_size % accum:
            raise ValueError(f"accum_steps={accum} must divide "
                             f"batch_size={cfg.batch_size}")
        X, y = np.asarray(X), np.asarray(y)
        scope, seq_info = self._resolve_seq_attention(X)
        autoconfig.update(seq_info)
        n = len(X)
        steps_per_epoch = cfg.steps_per_epoch or max(n // cfg.batch_size, 1)
        total_steps = steps_per_epoch * cfg.max_epochs
        named = list(self.model.named_parameters())
        opt = Optimizer(cfg, total_steps, named)
        params = [p for _, p in named]
        self._names = [n for n, _ in named]
        world = self._world()
        if world > 1 and any(isinstance(m, BatchNorm)
                             for m in self.model.modules()):
            raise NotImplementedError(
                "BatchNorm on a mesh of more than one rank is not ported to "
                "the PyTorch package yet (the JAX package normalises over "
                "the global batch)")
        self.stats = {}
        if self._seq_variant:
            self.stats["seq_attention"] = self._seq_variant
        if autoconfig:
            self.stats["autoconfig"] = autoconfig
        self.model.train()
        history, step_idx = [], 0
        with scope:
            for epoch in range(cfg.max_epochs):
                rng_e = np.random.default_rng([cfg.seed, epoch])
                losses, t0 = [], time.perf_counter()
                for xb, yb in self._batches(X, y, rng_e):
                    losses.append(self._step(xb, yb, step_idx, accum, world,
                                             params, opt))
                    step_idx += 1
                ep = {"epoch": epoch,
                      "loss": float(np.mean(losses)) if losses
                      else float("nan"),
                      "steps": len(losses),
                      "seconds": time.perf_counter() - t0}
                if valid is not None:
                    ep["val_acc"] = self.evaluate(valid[0], valid[1])
                history.append(ep)
                if log_fn:
                    log_fn(ep)
        self.model.eval()
        self.history = history
        return self

    def _step(self, xb, yb, step_idx, accum, world, params, opt) -> float:
        cfg, dev = self.cfg, self.device
        xs = np.split(xb, accum) if accum > 1 else [xb]
        ys = np.split(yb, accum) if accum > 1 else [yb]
        for p in params:
            p.grad = None
        t = {"forward_s": 0.0, "backward_s": 0.0}
        loss_sum = 0.0
        for i, (xm, ym) in enumerate(zip(xs, ys)):
            key = (cfg.seed, step_idx) if accum == 1 else \
                (cfg.seed, step_idx, i)
            gen = torch.Generator(device=dev)
            gen.manual_seed(_step_seed(*key))
            t0 = time.perf_counter()
            logits = self.model(self._input(xm), train=True, generator=gen)
            loss = F.cross_entropy(logits.float(),
                                   torch.as_tensor(ym, device=dev).long())
            _sync(dev)
            t1 = time.perf_counter()
            (loss / (accum * world)).backward()
            _sync(dev)
            t["forward_s"] += t1 - t0
            t["backward_s"] += time.perf_counter() - t1
            loss_sum += float(loss.detach())
        loss_val = loss_sum / accum
        if not math.isfinite(loss_val):
            raise NonFiniteLossError(
                f"non-finite training loss {loss_val} at step {step_idx} "
                "(nonfinite_policy='raise')")
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        t0 = time.perf_counter()
        if world > 1:
            flat = torch.cat([g.reshape(-1) for g in grads])
            all_reduce_sum(flat)
            grads = [g.view_as(p) for g, p in
                     zip(flat.split([p.numel() for p in params]), params)]
        _sync(dev)
        t1 = time.perf_counter()
        opt.step(grads)
        _sync(dev)
        t.update(allreduce_s=t1 - t0, update_s=time.perf_counter() - t1,
                 loss=loss_val, step=step_idx)
        norms = torch.stack([g.norm() for g in grads]).tolist()
        t["grad_norms"] = dict(zip(self._names, norms))
        self.step_stats.append(t)
        return loss_val

    # --- eval / predict ---------------------------------------------------
    @torch.no_grad()
    def predict_logits(self, X, batch_size: Optional[int] = None
                       ) -> np.ndarray:
        """float32 logits of ``X`` in batches of ``batch_size`` (default the
        config's); the tail batch is padded with copies of its last row, as
        the JAX package pads it, and the padding cut off."""
        bs = batch_size or self.cfg.batch_size
        X = np.asarray(X)
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
