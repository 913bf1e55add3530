"""MPMD pipeline-parallel training over the ``stage`` mesh axis.

Counterpart of the JAX package's ``dl/pipeline.py`` (``fit_pipeline``, the
``param_sharding="pipeline"`` body of ``Trainer.fit``). The mesh's
``stage`` axis is split into stage groups (``parallel.stage_submeshes``);
model stage s runs on group ``s % G`` (circular placement), and each rank
builds, runs and updates only the stages whose group holds it. Each global
batch is cut into M microbatches (``pipeline_microbatches``, 0 for one per
group) that flow through one of two schedules:

* ``"fill_drain"`` (GPipe): the forward wavefront (microbatch m enters
  stage s at tick s + m) keeps only each stage's inputs; the last stage
  fuses loss and backward; the backward wavefront recomputes each upstream
  stage's forward under ``torch.enable_grad()`` (its BatchNorm running
  statistics put back afterwards) and pulls the cotangent through it with
  ``torch.autograd.grad``, giving that stage's parameter gradients and its
  input's cotangent.
* ``"overlap"`` (1F1B): the forward keeps its autograd graph, which plays
  the part of the JAX package's saved residuals, so the backward does no
  recompute; a backward runs as soon as its cotangent has landed, upstream
  first and microbatches in order, so each stage sums its gradients in
  fill-drain's order. Under ``pipeline_param_sharding="zero"`` each stage's
  gathered weights are double-buffered: the next batch's all-gather is
  issued right after this batch's update, and a restore drops the buffer.

Activations and cotangents hop between groups through
``parallel.transfer.device_transfer``: from the rank at (group g, other
coordinates c) to the rank at (group g', c), sends posted without waiting
and receives waited for when read, so the groups compute at the same time.
Inside a group the other axes survive: on a ``data`` axis of 2 or more
ranks that divides the microbatch, each rank runs its own rows (BatchNorm
over the axis, as in the replicated trainer); a ``seq`` axis runs each
stage's attention seq-sharded over the group (``seq_attention_scope`` of
the group's mesh). Each rank scales its microbatch loss by ``1 / (M ·
ranks in the group)``; after the schedule one all-reduce over the group
sums every stage's gradients, and every stage takes one optimizer step per
global batch on the gradients averaged over the microbatches. A model
without BatchNorm or dropout therefore follows the replicated trajectory.
``pipeline_param_sharding="zero"`` (or ``"fsdp"``) keeps each stage's
parameters and moments at rest as this rank's blocks over its group's
``data`` axis (``ShardSpec``), as the replicated trainer's ZeRO does; a
group without a ``data`` axis of 2 or more ranks keeps them whole.

Checkpoints are the sharded per-stage format of
``core.checkpoint.save_sharded_tree`` (``{"params", "batch_stats",
"opt_state"}`` keyed by ``stages_{k}``; each window written by the lowest
rank holding it), which reshards on load, so a shrunken mesh resumes the
state. ``preemption_point("dl.epoch", e)``, the three ``nonfinite_policy``
values and ``resume`` work as in the replicated trainer. After the fit
every rank holds the whole model (``transfer.host_fetch`` from each stage's
owner), so ``predict_logits`` and ``evaluate`` run it whole.

``tr.step_stats`` holds per step the loss and this rank's seconds of
forward, backward, hops and update (CUDA events on the card), its busy and
wall seconds and idle share (the bubble), the seconds inside the
collectives of its stages and its update (``parallel.collectives.
COMM_SECONDS``), the host seconds inside hops (staging and waiting for a
landing), and the hops and hop bytes it sent and received.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.checkpoint import (CheckpointError, CheckpointStore, LocalBlock,
                               NonFiniteGuard, NonFiniteLossError,
                               load_sharded_from_checkpoint, preemption_point,
                               save_sharded_tree)
from ..core.device import on_device_thread
from ..core.logging import record_failure
from ..parallel import transfer
from ..parallel.collectives import COMM_SECONDS, all_gather, all_reduce_sum
from ..parallel.elastic import ElasticUnsupportedError, current_watchdog
from ..parallel.mesh import (DATA_AXIS, STAGE_AXIS,
                             assert_equal_across_processes,
                             local_mesh_devices, process_count,
                             stage_submeshes, tree_shardings)
from . import trainer as _trainer_mod
from .backbones import StageSequential, seq_attention_scope
from .layers import batch_stats_over

#: The supported-config matrix of the JAX package's DL scaling (every cell
#: True); :class:`ElasticUnsupportedError` carries it whenever a config
#: falls outside it.
SUPPORTED_MATRIX = {
    "single-process pipeline (any #stages/groups)": True,
    "multi-process param_sharding='replicated'": True,
    "multi-process param_sharding='zero'/'fsdp'": True,
    "multi-process param_sharding='pipeline'": True,
    "pipeline schedule='overlap' (double-buffered stage weights)": True,
    "elastic shrink/regrow resume (zero/fsdp/pipeline, gbdt fused)": True,
    "seq-sharded attention (mesh 'seq' axis: ring or ulysses variant)": True,
    "seq x zero/fsdp (attention over 'seq', state over 'data')": True,
    "seq within pipeline stage groups (fill_drain and overlap)": True,
    "multi-process seq-sharded attention": True,
}

_SCHEDULES = ("fill_drain", "overlap")


def _act_tag(boundary: int) -> int:
    """Hop stream of the activations from stage ``boundary`` to the next."""
    return 2 * boundary + 1


def _cot_tag(boundary: int) -> int:
    """Hop stream of the cotangents from stage ``boundary + 1`` back."""
    return 2 * boundary + 2


class _Clock:
    """Seconds by kind of this rank's stage programs: CUDA events on the
    card (summed once the step's work has finished), the host clock on the
    CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans: List[tuple] = []
        self.seconds: dict = {}

    @contextlib.contextmanager
    def span(self, kind: str):
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self.spans.append((kind, a, b))
        else:
            t0 = time.perf_counter()
            yield
            self.seconds[kind] = self.seconds.get(kind, 0.0) + \
                time.perf_counter() - t0

    def read(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
            for kind, a, b in self.spans:
                self.seconds[kind] = self.seconds.get(kind, 0.0) + \
                    a.elapsed_time(b) / 1e3
        out, self.spans, self.seconds = dict(self.seconds), [], {}
        return out


class _Stage:
    """Model stage ``index`` as this rank sees it: its module, group mesh,
    parameters and, when this rank's group holds it, its ZeRO specs and
    optimizer (a template optimizer on meta tensors otherwise, for the
    checkpoint's structure)."""

    def __init__(self, index: int, module, mesh, zero: bool, cfg,
                 total_steps: int):
        self.index, self.key = index, f"stages_{index}"
        self.module, self.mesh = module, mesh
        self.owned = mesh.rank is not None
        named = list(module.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.shapes = [tuple(p.shape) for p in self.params]
        self.specs = None
        self.gbuf = None
        if self.owned and zero and int(mesh.shape.get(DATA_AXIS, 1)) > 1:
            spec = tree_shardings(mesh, named, "zero")
            self.specs = [spec[n] for n in self.names]
            self.dp = int(mesh.shape[DATA_AXIS])
            self.dp_index = mesh.axis_index(DATA_AXIS)
            opt_named = [(n, s.take(p.detach(), self.dp_index).clone()
                          if s.dim is not None else p.detach())
                         for (n, p), s in zip(named, self.specs)]
        elif self.owned:
            opt_named = named
        else:
            opt_named = [(n, torch.empty(p.shape, dtype=p.dtype,
                                         device="meta")) for n, p in named]
        self.opt = _trainer_mod.Optimizer(cfg, total_steps, opt_named)
        self.opt.whole_shapes = list(self.shapes)
        mask = _trainer_mod.freeze_mask(
            [f"{self.key}.{n}" for n in self.names], cfg.freeze_regex)
        if mask is not None:
            self.opt.trainable = [mask[f"{self.key}.{n}"]
                                  for n in self.names]
        self.release()

    # --- ZeRO placement ------------------------------------------------
    def sharded(self) -> List[int]:
        return [] if self.specs is None else \
            [i for i, s in enumerate(self.specs) if s.dim is not None]

    @torch.no_grad()
    def gathered(self) -> Optional[List[torch.Tensor]]:
        """The whole tensors of this rank's sharded blocks: one flat
        ``all_gather`` over the group's data axis (None when nothing is
        sharded)."""
        idx = self.sharded()
        if not idx:
            return None
        blocks = [self.opt.params[i] for i in idx]
        flat = torch.cat([b.reshape(-1) for b in blocks])
        parts = all_gather(flat, self.mesh.group(DATA_AXIS), axis=0) \
            .view(self.dp, -1)
        out, off = [], 0
        for i, b in zip(idx, blocks):
            k = b.numel()
            out.append(torch.cat([parts[r, off: off + k].view(b.shape)
                                  for r in range(self.dp)],
                                 dim=self.specs[i].dim))
            off += k
        return out

    def take_gathered(self) -> None:
        """The whole weights into the module: the prefetched buffer when
        there is one, else a gather now."""
        whole, self.gbuf = (self.gbuf if self.gbuf is not None
                            else self.gathered()), None
        for i, t in zip(self.sharded(), whole or ()):
            self.params[i].data = t

    def prefetch(self) -> None:
        """Gather the next batch's weights now (the overlap schedule's
        double buffer)."""
        self.gbuf = self.gathered()

    def release(self) -> None:
        for i in self.sharded():
            p = self.params[i]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    # --- the checkpoint tree ---------------------------------------------
    def _leader(self) -> bool:
        return self.owned and self.mesh.rank == 0

    def _leaf(self, i: Optional[int], t: torch.Tensor, meta: bool):
        """A checkpoint leaf of this rank: its block of parameter ``i``'s
        tensor ``t`` (``i`` None: a tensor every rank of the group holds
        whole), or an empty window when its group does not hold the
        stage."""
        if meta:
            t = torch.empty(t.shape, dtype=t.dtype, device="meta")
        if not self.owned:
            shape = self.shapes[i] if i is not None else tuple(t.shape)
            data = torch.empty((0,) * len(shape), dtype=t.dtype,
                               device="meta" if meta else "cpu")
            return LocalBlock(data, shape, tuple((0, 0) for _ in shape),
                              False)
        shape = self.shapes[i] if i is not None else tuple(t.shape)
        if i is not None and self.specs is not None \
                and self.specs[i].dim is not None:
            owner = all(c == 0 for a, c in self.mesh.coords.items()
                        if a != DATA_AXIS)
            return LocalBlock(t, shape,
                              self.specs[i].window(shape, self.dp_index),
                              owner)
        return LocalBlock(t, shape, tuple((0, int(d)) for d in shape),
                          self._leader())

    def tree(self, meta: bool = False) -> tuple:
        """(params, batch_stats, opt_state) of this stage as checkpoint
        leaves (meta tensors for a restore's template)."""
        nest_sorted = _trainer_mod.nest_sorted
        params = nest_sorted({n.replace(".", "/"): self._leaf(
            i, self.opt.params[i] if self.owned else self.params[i], meta)
            for i, n in enumerate(self.names)})
        stats = nest_sorted({n.replace(".", "/"): self._leaf(None, b, meta)
                             for n, b in self.module.named_buffers()})
        opt = self.opt.state_dict(lambda i, t: self._leaf(i, t, meta))
        opt = _trainer_mod._map_tensors(opt, lambda t: self._leaf(None, t,
                                                                  meta))
        return params, stats, opt

    @torch.no_grad()
    def load(self, params: dict, stats: dict, opt) -> None:
        """Load this rank's restored blocks (CPU tensors)."""
        if not self.owned:
            return
        flat = _trainer_mod._flat_paths(params)
        for i, n in enumerate(self.names):
            self.opt.params[i].copy_(flat[n.replace(".", "/")])
        sflat = _trainer_mod._flat_paths(stats)
        for n, b in self.module.named_buffers():
            b.copy_(sflat[n.replace(".", "/")])
        self.opt.load_state_dict(opt)
        self.gbuf = None

    def state_bytes(self) -> int:
        """Bytes of parameters and optimizer state this rank holds at rest
        for the stage (0 when its group does not hold it)."""
        if not self.owned:
            return 0
        moments = sum(m is not None for m in (self.opt.mu, self.opt.nu))
        counts = 2 if self.opt.kind in ("adam", "adamw") else 1
        total = 0
        for i, shape in enumerate(self.shapes):
            numel = int(np.prod(shape))
            if self.specs is not None:
                numel = self.specs[i].shard_numel(shape)
            total += numel * self.params[i].element_size() * (1 + moments)
        return total + 4 * counts


def fit_pipeline(tr, X, y, valid: Optional[tuple] = None,
                 log_fn: Optional[Callable] = None):
    """The ``param_sharding="pipeline"`` body of ``Trainer.fit``: the same
    contract (epoch history, checkpoints and resume, non-finite policies,
    the batch hook), on the stage groups of ``tr.mesh``. Every rank of the
    mesh calls it with the same arguments."""
    cfg, model = tr.cfg, tr.model
    if not isinstance(model, StageSequential):
        raise ValueError(
            "param_sharding='pipeline' needs a dl.StageSequential model — "
            "build one with dl.make_staged_backbone(...) or "
            "dl.staged_text_encoder(...)")
    if tr.mesh is None or STAGE_AXIS not in tr.mesh.shape:
        raise ValueError(
            "param_sharding='pipeline' requires a mesh with a 'stage' axis, "
            "e.g. parallel.make_mesh({'stage': G, 'data': D})")
    schedule, sched_dec = cfg.pipeline_schedule, None
    if schedule == "auto":
        from ..core.perfmodel import suggest_pipeline_schedule

        m_hint = (int(cfg.pipeline_microbatches)
                  or int(tr.mesh.shape[STAGE_AXIS]))
        schedule, sched_dec = suggest_pipeline_schedule(len(model.stages),
                                                        m_hint)
    if schedule not in _SCHEDULES:
        raise ElasticUnsupportedError(
            f"pipeline schedule {schedule!r}", matrix=SUPPORTED_MATRIX,
            hint=f"pipeline_schedule must be one of {_SCHEDULES}")
    overlap = schedule == "overlap"
    X, y = np.asarray(X), np.asarray(y)
    dev = tr.device
    S = len(model.stages)
    G = int(tr.mesh.shape[STAGE_AXIS])
    M = int(cfg.pipeline_microbatches) or G
    if cfg.batch_size % M:
        raise ValueError(
            f"batch_size={cfg.batch_size} must split into "
            f"pipeline_microbatches={M} equal microbatches")
    groups, assign = stage_submeshes(tr.mesh, S)
    zero = cfg.pipeline_param_sharding in ("zero", "fsdp")
    n = len(X)
    steps_per_epoch = cfg.steps_per_epoch or max(n // cfg.batch_size, 1)
    total_steps = steps_per_epoch * cfg.max_epochs
    if process_count() > 1:
        local_mesh_devices(tr.mesh)
        assert_equal_across_processes(
            [n, S, M, cfg.batch_size, cfg.max_epochs],
            "pipeline config (rows/stages/microbatches/batch/epochs)")

    gm = [groups[assign[s]] for s in range(S)]
    stages = [_Stage(s, model.stages[s], gm[s], zero, cfg, total_steps)
              for s in range(S)]
    owns = [st.owned for st in stages]
    mine = groups[tr.mesh.axis_index(STAGE_AXIS)]
    seq_variant = tr._seq_variant
    dp = int(mine.shape.get(DATA_AXIS, 1))
    group_world = int(np.prod(list(mine.shape.values())))
    hops = transfer.Hops(dev)
    last_src = gm[S - 1].ranks[0]
    world_group = tr.mesh.world_group

    # a microbatch's rows: on a data axis of 2 or more ranks that divides
    # them, each rank runs its block (BatchNorm over the axis)
    mb_rows = min(n, cfg.batch_size) // M
    rows, bn_group = slice(None), None
    if seq_variant is None and dp >= 2 and mb_rows % dp == 0:
        b, j = mb_rows // dp, mine.axis_index(DATA_AXIS)
        rows, bn_group = slice(j * b, (j + 1) * b), mine.group(DATA_AXIS)

    def run(s: int, x, step: int, m: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_trainer_mod._step_seed(cfg.seed, step, s, m))
        scope = (seq_attention_scope(gm[s], seq_variant) if seq_variant
                 else contextlib.nullcontext())
        with scope, batch_stats_over(bn_group):
            return stages[s].module(x, train=True, generator=gen)

    def pull(s, out, leaf, cot):
        """(parameter gradients, input cotangent) of stage ``s``."""
        inputs = list(stages[s].params)
        wrt_x = leaf is not None and leaf.requires_grad
        if wrt_x:
            inputs.append(leaf)
        grads = torch.autograd.grad(out, inputs, grad_outputs=cot,
                                    allow_unused=True)
        return grads[: len(stages[s].params)], (grads[-1] if wrt_x
                                                else None)

    def accumulate(gacc, s, dps):
        if gacc[s] is None:
            gacc[s] = [None if g is None else g.detach() for g in dps]
            return
        for i, g in enumerate(dps):
            if g is not None:
                gacc[s][i] = g.detach() if gacc[s][i] is None \
                    else gacc[s][i] + g

    def as_leaf(x, s):
        x = x.detach()
        if s > 0 and x.is_floating_point():
            x.requires_grad_(True)
        return x

    def pipeline_step(step: int, xb, yb, clock: _Clock):
        """One global batch through the schedule: (mean loss, gradient
        sums by stage). Every rank runs every tick; a step that stops
        early still waits for its hops in flight."""
        try:
            return schedule_step(step, xb, yb, clock)
        finally:
            hops.drain()

    def schedule_step(step: int, xb, yb, clock: _Clock):
        xmb, ymb = np.split(np.asarray(xb), M), np.split(np.asarray(yb), M)
        x_in = [[None] * M for _ in range(S)]
        keep = [[None] * M for _ in range(S)]      # overlap: (leaf, out)
        gy = [[None] * M for _ in range(S)]
        landed = [[False] * M for _ in range(S)]
        done = [[False] * M for _ in range(S)]
        dx_last = [None] * M
        gacc = [None] * S
        losses = []
        scale = 1.0 / (M * group_world)
        wd = current_watchdog()
        for s in range(S):
            if owns[s] and stages[s].specs is not None:
                stages[s].take_gathered()

        def bwd(s, m):
            g = transfer.value(gy[s][m])
            if overlap:
                leaf, out = keep[s][m]
                keep[s][m] = None
                with clock.span("backward"):
                    dps, dx = pull(s, out, leaf, g)
            else:
                x = x_in[s][m]
                x_in[s][m] = None
                leaf = as_leaf(x, s)
                saved = [b.detach().clone()
                         for b in stages[s].module.buffers()]
                with clock.span("backward"), torch.enable_grad():
                    out = run(s, leaf, step, m)
                    dps, dx = pull(s, out, leaf, g)
                with torch.no_grad():
                    for b, v in zip(stages[s].module.buffers(), saved):
                        b.copy_(v)
            accumulate(gacc, s, dps)
            return dx

        def hop_back(s, m, dx):
            """The cotangent of stage ``s``'s input to stage ``s - 1``."""
            with clock.span("hop"):
                gy[s - 1][m] = transfer.device_transfer(
                    dx, gm[s], gm[s - 1], hops, _cot_tag(s - 1))
            landed[s - 1][m] = True

        def drain_bwd():
            # 1F1B: every backward whose cotangent has landed, upstream
            # first, microbatches in order
            progress = True
            while progress:
                progress = False
                for s in range(S - 2, -1, -1):
                    for m in range(M):
                        if not landed[s][m] or done[s][m]:
                            continue
                        dx = bwd(s, m) if owns[s] else None
                        done[s][m] = True
                        if s > 0:
                            hop_back(s, m, dx)
                        progress = True

        for t in range(S + M - 1):
            if wd is not None:
                wd.beat("dl.pipeline.hop", t)
            for s in range(S):
                m = t - s
                if not 0 <= m < M:
                    continue
                if s == 0:
                    xin = transfer.device_transfer(
                        np.ascontiguousarray(xmb[m][rows]), gm[0], gm[0],
                        hops, 0)
                    if xin is not None:
                        xin = tr._input(xin)
                else:
                    xin = x_in[s][m]
                if s < S - 1:
                    ys = None
                    if owns[s]:
                        x = transfer.value(xin)
                        if overlap:
                            leaf = as_leaf(x, s)
                            with clock.span("forward"), torch.enable_grad():
                                out = run(s, leaf, step, m)
                            keep[s][m] = (leaf, out)
                            ys = out.detach()
                        else:
                            x_in[s][m] = x
                            with clock.span("forward"), torch.no_grad():
                                ys = run(s, x, step, m)
                    with clock.span("hop"):
                        x_in[s + 1][m] = transfer.device_transfer(
                            ys, gm[s], gm[s + 1], hops, _act_tag(s))
                    continue
                dx = None
                if owns[s]:
                    leaf = as_leaf(transfer.value(xin), s)
                    lab = torch.as_tensor(ymb[m][rows], device=dev).long()
                    with clock.span("forward"), torch.enable_grad():
                        logits = run(s, leaf, step, m)
                        loss = F.cross_entropy(logits.float(), lab)
                    with clock.span("backward"):
                        dps, dx = pull(s, loss * scale, leaf, None)
                    accumulate(gacc, s, dps)
                    losses.append(loss.detach())
                if overlap and S > 1:
                    hop_back(s, m, dx)
                else:
                    dx_last[m] = dx
            if overlap:
                drain_bwd()
        if not overlap and S > 1:
            for m in range(M):
                hop_back(S - 1, m, dx_last[m])
            for t in range(M + S - 1):
                for s in range(S - 2, -1, -1):
                    m = t - (S - 2 - s)
                    if not 0 <= m < M or not landed[s][m]:
                        continue
                    dx = bwd(s, m) if owns[s] else None
                    if s > 0:
                        hop_back(s, m, dx)
        with clock.span("hop"):
            hops.drain()
        loss = float("nan")
        if owns[S - 1]:
            mean = torch.stack(losses).double().mean().cpu()
            if bn_group is not None:
                mean = all_reduce_sum(mean, bn_group) / dp
            loss = float(mean)
        loss = transfer.share_scalars([loss], last_src, world_group)[0]
        return loss, gacc

    def apply(gacc, clock: _Clock) -> None:
        """Every owned stage's optimizer step on its summed gradients."""
        for s, st in enumerate(stages):
            if not owns[s]:
                continue
            with clock.span("update"):
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(st.params, gacc[s]
                                         or [None] * len(st.params))]
                if group_world > 1:
                    flat = torch.cat([g.reshape(-1) for g in grads])
                    all_reduce_sum(flat, st.mesh.world_group)
                    grads = [g.view_as(p) for g, p in zip(
                        flat.split([p.numel() for p in st.params]),
                        st.params)]
                g_norm = None
                if st.specs is not None:
                    if st.opt.clip > 0:
                        g_norm = torch.sqrt(sum(torch.sum(g * g)
                                                for g in grads))
                    grads = [st.specs[i].take(g, st.dp_index)
                             for i, g in enumerate(grads)]
                st.opt.step(grads, g_norm)
                st.release()
                if overlap:
                    st.prefetch()

    def drop(clock: _Clock) -> None:
        for s, st in enumerate(stages):
            if owns[s]:
                st.release()
                if overlap:
                    st.prefetch()
        clock.read()

    # --- checkpoints (the sharded per-stage format) ------------------------
    def tree(meta: bool = False) -> dict:
        parts = [st.tree(meta) for st in stages]
        return {"params": {st.key: p[0] for st, p in zip(stages, parts)},
                "batch_stats": {st.key: p[1] for st, p in zip(stages, parts)
                                if p[1]},
                "opt_state": {st.key: p[2] for st, p in zip(stages, parts)}}

    def save(store: CheckpointStore, epoch: int) -> None:
        save_sharded_tree(store, epoch, tree(),
                          meta={"kind": "dl-trainer", "epoch": int(epoch),
                                "format": "sharded"},
                          group=world_group)

    def restore(store: CheckpointStore) -> Optional[int]:
        ckpt = store.load_latest(artifact_filter=lambda n: n in (
            "state.msgpack", "state.sharding.json"))
        if ckpt is None:
            return None
        if "state.sharding.json" not in ckpt.artifacts:
            record_failure("checkpoint.pytree_mismatch", base=ckpt.base,
                           reason="missing state.sharding.json artifact")
            raise ValueError(
                f"checkpoint {ckpt.base} in {store.dir} has no sharded "
                "pipeline state; point checkpoint_dir at a fresh directory")
        try:
            got = load_sharded_from_checkpoint(store, ckpt, tree(meta=True))
        except (CheckpointError, ValueError, KeyError) as e:
            record_failure("checkpoint.pytree_mismatch", base=ckpt.base,
                           error=str(e)[:200])
            raise ValueError(
                f"checkpoint {ckpt.base} in {store.dir} does not match the "
                "current model/optimizer structure (architecture or "
                f"optimizer changed since it was saved): {e}. Delete the "
                "checkpoint directory or set resume=False to train from "
                "scratch") from e
        for st in stages:
            st.load(got["params"][st.key],
                    got["batch_stats"].get(st.key, {}),
                    got["opt_state"][st.key])
        return int(ckpt.meta.get("epoch", ckpt.step))

    def publish() -> None:
        """Every stage's parameters and buffers, from the first rank of its
        group, into every rank's model."""
        for st in stages:
            whole = None
            if st.owned and st.specs is not None:
                whole = st.gathered()
            tensors = [p.detach() for p in st.opt.params] if st.owned \
                else [torch.empty(sh, dtype=p.dtype)
                      for sh, p in zip(st.shapes, st.params)]
            for i, t in zip(st.sharded(), whole or ()):
                tensors[i] = t
            bufs = list(st.module.buffers())
            got = transfer.host_fetch(tensors + [b.detach() for b in bufs],
                                      st.mesh.ranks[0], world_group)
            with torch.no_grad():
                for p, t in zip(st.params, got):
                    p.data = t.to(dev)
                for b, t in zip(bufs, got[len(tensors):]):
                    b.copy_(t)

    store = (CheckpointStore(cfg.checkpoint_dir,
                             keep_last=max(cfg.keep_checkpoints, 1))
             if cfg.checkpoint_dir else None)
    start_epoch = 0
    if store is not None and cfg.resume:
        restored = restore(store)
        if restored is not None:
            start_epoch = restored
    tr.stats = {"state_bytes_per_rank": sum(st.state_bytes()
                                            for st in stages),
                "stages": S, "groups": G, "microbatches": M,
                "schedule": schedule}
    if seq_variant:
        tr.stats["seq_attention"] = seq_variant
    auto_info = dict(getattr(tr, "_seq_autoconfig", {}) or {})
    if sched_dec is not None:
        auto_info["pipeline_schedule"] = sched_dec.provenance()
    if auto_info:
        tr.stats["autoconfig"] = auto_info
    guard = NonFiniteGuard(policy=cfg.nonfinite_policy,
                           counter_prefix="train")
    skip = cfg.nonfinite_policy == "skip"
    model.train()
    history = []
    step_idx = start_epoch * steps_per_epoch
    epoch = start_epoch
    clock = _Clock(dev)
    while epoch < cfg.max_epochs:
        preemption_point("dl.epoch", epoch)
        rng_e = np.random.default_rng([cfg.seed, epoch])
        losses = []
        t0 = time.perf_counter()
        rolled_back = False
        for i, (xb, yb) in enumerate(tr._batches(X, y, rng_e)):
            hook = _trainer_mod._CHAOS_BATCH_HOOK
            if hook is not None:
                xb, yb = hook(epoch * steps_per_epoch + i, xb, yb)
            saved = ([[b.detach().clone() for b in st.module.buffers()]
                      for st in stages] if skip else None)
            hops.reset_counts()
            _trainer_mod._sync(dev)
            comm0 = sum(COMM_SECONDS.values())
            t_step = time.perf_counter()
            wd = current_watchdog()
            if wd is not None:
                loss, gacc = wd.run(
                    on_device_thread(dev, pipeline_step),
                    step_idx, xb, yb, clock, op="dl.pipeline.step")
                wd.beat("dl.pipeline.step", step_idx)
            else:
                loss, gacc = pipeline_step(step_idx, xb, yb, clock)
            action = guard.check(loss, step_idx)
            if action == "skip":
                with torch.no_grad():
                    for st, bufs in zip(stages, saved):
                        for b, v in zip(st.module.buffers(), bufs):
                            b.copy_(v)
                drop(clock)
                step_idx += 1
                continue
            if action == "rollback":
                drop(clock)
                restored = restore(store) if store is not None else None
                if restored is None:
                    raise NonFiniteLossError(
                        "nonfinite_policy='rollback' found no checkpoint to "
                        "restore (set checkpoint_dir and let at least one "
                        "epoch complete, or use policy 'skip'/'raise')")
                epoch = restored
                step_idx = epoch * steps_per_epoch
                rolled_back = True
                break
            apply(gacc, clock)
            del gacc
            secs = clock.read()
            _trainer_mod._sync(dev)
            wall = time.perf_counter() - t_step
            busy = sum(secs.get(k, 0.0)
                       for k in ("forward", "backward", "update"))
            tr.step_stats.append({
                "step": step_idx, "loss": loss, "wall_s": wall,
                "forward_s": secs.get("forward", 0.0),
                "backward_s": secs.get("backward", 0.0),
                "hop_s": secs.get("hop", 0.0),
                "update_s": secs.get("update", 0.0), "busy_s": busy,
                "collective_s": sum(COMM_SECONDS.values()) - comm0,
                "idle_share": max(0.0, 1.0 - busy / wall) if wall else 0.0,
                "hop_wait_s": hops.seconds, "hops": hops.count,
                "hop_bytes": hops.bytes})
            step_idx += 1
            losses.append(loss)
        if rolled_back:
            continue
        ep = {"epoch": epoch,
              "loss": float(np.mean(losses)) if losses else float("nan"),
              "steps": len(losses),
              "seconds": time.perf_counter() - t0}
        if valid is not None:
            publish()
            ep["val_acc"] = tr.evaluate(valid[0], valid[1])
            model.train()
            for st in stages:
                if st.owned:
                    st.release()
        history.append(ep)
        if log_fn:
            log_fn(ep)
        if store is not None and (epoch + 1) % cfg.save_every_epochs == 0:
            save(store, epoch + 1)
        epoch += 1
    publish()
    tr.specs, tr.optimizer = None, None
    model.eval()
    tr.history = history
    return tr

