"""Batched sparse SGD engine — the port's VowpalWabbit core.

The port's counterpart of the JAX package's ``vw/learner.py``. The
reference's native learner consumes one example at a time (JNI
``vw.learn``) and averages weights across workers with a spanning-tree
AllReduce at pass / sync-schedule boundaries
(VowpalWabbitBaseLearner.scala:130-188, VowpalWabbitSyncSchedule.scala:
22-62). Here:

  - examples are padded sparse batches: ``idx``/``val`` arrays of shape
    (B, P) (P = max active features per example); a pass walks the
    (num_batches, B, P) stack batch by batch on the state's device, the
    JAX package's ``lax.scan`` body as PyTorch operations
  - the model is a dense weight vector of size 2**num_bits; sparse dot =
    gather + multiply + row sum; updates = ``index_add_`` (scatter-add),
    in place on the state's tensors
  - adaptive (adagrad) updates mirror VW's ``--adaptive`` default;
    invariant lr-decay ``--power_t`` for the non-adaptive path
  - data parallelism: rows split over the mesh ``data`` axis; weights are
    averaged over the axis at each sync-segment boundary through the psum
    family of ``parallel.collectives`` (every rank's values gathered and
    folded in rank order, so every rank holds the same bits)
  - progressive validation loss is accumulated pre-update per batch,
    matching VW's reported progressive loss semantics

Sums in another order. On the CPU the port's row sums, batch sums and
scatter-adds run in PyTorch's order, the JAX package's in XLA's (which
contracts products into fused multiply-adds and folds long sums in vector
lanes), and ``exp`` / ``log1p`` come from other libraries: the two packages
agree to float32 roundoff, not bit for bit (the tests state the bound). On
the card ``index_add_`` adds repeated indices by atomics in no fixed order,
so two card passes differ in their last bits too.

Launches. Eager, one batch is about fifteen small kernel launches (gather,
multiply, row sum, loss, the scatter-adds, the square root, the scalar
updates), so a pass over small batches is bound by launches, not by the
card's memory.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..parallel.mesh import DATA_AXIS

SPARSE_DTYPE = np.dtype([("idx", "<i4"), ("val", "<f4")])


def make_sparse_batch(indices_list, values_list, pad_to: Optional[int] = None) -> np.ndarray:
    """Pack per-row (indices, values) into a (N, P) structured array.

    Padded slots use idx=0, val=0 — a gather/scatter no-op (value 0 contributes
    nothing to dot products or gradients)."""
    n = len(indices_list)
    p = max((len(ix) for ix in indices_list), default=1)
    p = max(p, 1)
    if pad_to is not None:
        p = max(p, pad_to)
    out = np.zeros((n, p), dtype=SPARSE_DTYPE)
    for i, (ix, vv) in enumerate(zip(indices_list, values_list)):
        k = len(ix)
        if k:
            out["idx"][i, :k] = ix
            out["val"][i, :k] = vv
    return out


@dataclass(frozen=True)
class VWConfig:
    """Mirrors the reference's VW arg surface (VowpalWabbitBase.scala:213+
    ParamsStringBuilder args: -b, -l, --power_t, --l1, --l2, --loss_function,
    --passes, --hash_seed, --interactions)."""
    num_bits: int = 18
    learning_rate: float = 0.5
    power_t: float = 0.5
    initial_t: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    loss_function: str = "squared"     # squared | logistic | hinge | quantile
    quantile_tau: float = 0.5
    adaptive: bool = True
    num_passes: int = 1
    batch_size: int = 256
    hash_seed: int = 0
    # sync schedule: how many weight-averaging AllReduce segments per pass
    # (VowpalWabbitSyncScheduleSplits); 1 = average only at pass end.
    sync_splits: int = 1
    num_actions: int = 0               # >0 → contextual bandit cost regression
    cb_type: str = "ips"               # ips | mtr
    no_constant: bool = False          # --noconstant: no intercept term


_FIELDS = ("weights", "acc", "bias", "bias_acc", "t", "loss_sum", "weight_sum")


@dataclass
class VWState:
    """Learner state: dense weights + adagrad accumulator + progressive
    stats, float32 tensors on one device (the scalars 0-d)."""
    weights: torch.Tensor       # (2**num_bits,) f32
    acc: torch.Tensor           # (2**num_bits,) f32 — sum of squared gradients
    bias: torch.Tensor          # () f32
    bias_acc: torch.Tensor      # () f32
    t: torch.Tensor             # () f32 — example counter
    loss_sum: torch.Tensor      # () f32 — progressive validation loss
    weight_sum: torch.Tensor    # () f32

    _FIELDS = _FIELDS

    #: artifact name VWState checkpoints use inside a CheckpointStore step
    STORE_ARTIFACT = "vwstate.npz"

    def tree_flatten(self):
        """(the seven fields in order, None): the JAX package's pytree
        hooks, kept so code walking a state's leaves reads either
        package's."""
        return tuple(getattr(self, k) for k in _FIELDS), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def device(self) -> torch.device:
        return self.weights.device

    @property
    def progressive_loss(self) -> float:
        return float(self.loss_sum / torch.clamp(self.weight_sum, min=1e-12))

    @staticmethod
    def init(num_bits: int, device=DEFAULT_DEVICE) -> "VWState":
        dev = resolve_device(device)
        n = 1 << num_bits
        return VWState(torch.zeros(n, device=dev), torch.zeros(n, device=dev),
                       *(torch.zeros((), device=dev) for _ in range(5)))

    def arrays(self) -> dict:
        """The fields as host numpy arrays (float32; scalars 0-d), the
        layout of the JAX package's ``VWState`` leaves."""
        return {k: getattr(self, k).detach().cpu().numpy() for k in _FIELDS}

    @staticmethod
    def from_arrays(arrays: dict, device=DEFAULT_DEVICE) -> "VWState":
        """A state on ``device`` from a mapping of the seven fields (numpy
        arrays, e.g. a JAX ``VWState``'s leaves)."""
        dev = resolve_device(device)
        return VWState(*(torch.from_numpy(np.array(arrays[k], np.float32)
                                          ).to(dev) for k in _FIELDS))

    def to(self, device) -> "VWState":
        """A copy of this state on ``device`` (a card-to-card copy when it
        is already there)."""
        dev = resolve_device(device)
        return VWState(*(getattr(self, k).to(dev, copy=True)
                         for k in _FIELDS))

    def to_bytes(self) -> bytes:
        """Serialized model bytes — the VW `initialModel` warm-start analog
        (VowpalWabbitBaseLearner.scala:180-182). The JAX package's layout:
        either package loads the other's bytes."""
        buf = io.BytesIO()
        np.savez_compressed(buf, **self.arrays())
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes, device=DEFAULT_DEVICE) -> "VWState":
        """Parse serialized state onto ``device``; raises ``ValueError`` with
        a clear message on truncated/garbage payloads (a bad artifact must
        fail loudly at load, never deserialize into garbage)."""
        import zipfile
        try:
            z = np.load(io.BytesIO(bytes(data)), allow_pickle=False)
        except (ValueError, OSError, zipfile.BadZipFile, EOFError) as e:
            raise ValueError(
                f"VWState.from_bytes: payload is not a valid npz archive "
                f"(truncated write or garbage bytes: {e})") from e
        missing = [k for k in _FIELDS if k not in z.files]
        if missing:
            raise ValueError(
                f"VWState.from_bytes: archive is missing field(s) {missing} "
                f"(has {sorted(z.files)}) — not a VWState payload")
        try:
            arrays = {k: np.asarray(z[k]) for k in _FIELDS}
        except (ValueError, OSError, zipfile.BadZipFile, EOFError) as e:
            raise ValueError(
                f"VWState.from_bytes: archive member unreadable (truncated "
                f"payload: {e})") from e
        w, acc = arrays["weights"], arrays["acc"]
        if w.ndim != 1 or w.size == 0:
            raise ValueError(
                f"VWState.from_bytes: weights must be a non-empty 1-D "
                f"vector, got shape {w.shape}")
        if acc.shape != w.shape:
            raise ValueError(
                f"VWState.from_bytes: acc shape {acc.shape} does not match "
                f"weights shape {w.shape} — mixed or corrupt payload")
        for k in ("bias", "bias_acc", "t", "loss_sum", "weight_sum"):
            if arrays[k].shape != ():
                raise ValueError(
                    f"VWState.from_bytes: field {k!r} must be a scalar, got "
                    f"shape {arrays[k].shape}")
        return VWState.from_arrays(arrays, device)

    # -- CheckpointStore round-trip (the online learner loop snapshots
    # through these) --
    def save_to_store(self, store, step: int, meta: Optional[dict] = None) -> str:
        """Persist this state as one digest-verified
        :class:`~synapseml_tpu_torch.core.checkpoint.CheckpointStore`
        checkpoint; returns the checkpoint base name."""
        return store.save(int(step), {VWState.STORE_ARTIFACT: self.to_bytes()},
                          meta=meta)

    @staticmethod
    def load_from_store(store, step: Optional[int] = None,
                        device=DEFAULT_DEVICE):
        """Load ``(VWState, Checkpoint)`` from a CheckpointStore —
        ``step=None`` takes the newest checkpoint that VERIFIES (corrupt
        snapshots fall back per the store's recovery contract). Returns
        ``None`` when the store holds no usable checkpoint; raises
        ``ValueError`` when a verified checkpoint does not hold a parseable
        VWState artifact."""
        ckpt = store.load_step(step) if step is not None else store.load_latest()
        if ckpt is None:
            return None
        data = ckpt.artifacts.get(VWState.STORE_ARTIFACT)
        if data is None:
            raise ValueError(
                f"checkpoint {ckpt.base} holds no {VWState.STORE_ARTIFACT!r} "
                f"artifact (has {sorted(ckpt.artifacts)}) — not a VWState "
                "checkpoint")
        return VWState.from_bytes(data, device), ckpt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|))
    (PyTorch's ``softplus`` returns ``x`` above its threshold instead)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _loss_and_grad(p, y, loss: str, tau: float):
    """Returns (loss_value, dloss/dp). y convention: logistic/hinge use ±1."""
    if loss == "squared":
        return (p - y) ** 2, 2.0 * (p - y)
    if loss == "logistic":
        m = p * y
        # softplus(-m), not log1p(exp(-m)): the naive form overflows to inf
        # for m <= -88 in f32 (one bad outlier margin poisons the loss)
        return _softplus(-m), -y * torch.sigmoid(-m)
    if loss == "hinge":
        m = p * y
        return (torch.clamp(1.0 - m, min=0.0),
                torch.where(m < 1.0, -y, torch.zeros_like(y)))
    if loss == "quantile":
        e = y - p
        pos = e >= 0
        return (torch.where(pos, tau * e, (tau - 1.0) * e),
                torch.where(pos, torch.full_like(e, -tau),
                            torch.full_like(e, 1.0 - tau)))
    raise ValueError(f"unknown loss_function {loss!r}")


def _raw_predict(weights, bias, idx, val):
    return (weights[idx] * val).sum(dim=-1) + bias


def _step(st: VWState, idx, val, y, sw, cfg: VWConfig) -> torch.Tensor:
    """One batch of the pass, in place on ``st``: the JAX package's scan
    body (``_pass_body``). Returns the batch's pre-update predictions."""
    lr, l1, l2 = cfg.learning_rate, cfg.l1, cfg.l2
    flat = idx.reshape(-1)
    p = _raw_predict(st.weights, st.bias, idx, val)
    loss, dldp = _loss_and_grad(p, y, cfg.loss_function, cfg.quantile_tau)
    st.loss_sum += (loss * sw).sum()
    sw_sum = sw.sum()
    st.weight_sum += sw_sum

    g_ex = dldp * sw                              # (B,)
    g = g_ex[:, None] * val                       # (B, P) sparse grads
    if cfg.adaptive:
        st.acc.index_add_(0, flat, (g * g).reshape(-1))
        denom = torch.sqrt(st.acc[idx]) + 1e-6
        delta = -lr * g / denom
        if not cfg.no_constant:
            st.bias_acc += (g_ex * g_ex).sum()
            bias_delta = -lr * g_ex.sum() / (torch.sqrt(st.bias_acc) + 1e-6)
    else:
        eta = lr * (cfg.initial_t + (st.t + sw_sum)) ** (-cfg.power_t)
        delta = -eta * g
        if not cfg.no_constant:
            bias_delta = -eta * g_ex.sum()
    if l2 > 0.0:
        delta = delta - lr * l2 * st.weights[idx] * (val != 0)
    st.weights.index_add_(0, flat, delta.reshape(-1))
    if l1 > 0.0:
        touched = st.weights[idx]
        st.weights[flat] = (torch.sign(touched) * torch.clamp(
            torch.abs(touched) - lr * l1, min=0.0)).reshape(-1)
    if not cfg.no_constant:            # --noconstant: frozen intercept
        st.bias += bias_delta
    st.t += sw_sum
    return p


def _check_indices(idx: np.ndarray, size: int) -> None:
    """Refuse a hashed index outside the weight table before it reaches a
    gather: PyTorch raises there on the CPU and asserts on the card (which
    poisons the process's CUDA context), where the JAX package's gathers
    clamp. Callers hash into ``num_bits`` first, as the estimators and
    ``parse_lines`` do."""
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= size):
        raise ValueError(
            f"feature indices must lie in [0, {size}) (2**num_bits); got "
            f"[{int(idx.min())}, {int(idx.max())}]: mask the hashes with "
            "(1 << num_bits) - 1")


def _pack(idx, val, y, sw, batch_size):
    """Pad rows to a batch multiple and reshape to (nb, B, ...)."""
    n, p = idx.shape
    nb = max((n + batch_size - 1) // batch_size, 1)
    total = nb * batch_size
    pad = total - n

    def padded(a, fill=0):
        if pad == 0:
            return a
        width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill)

    return (padded(idx).reshape(nb, batch_size, p),
            padded(val).reshape(nb, batch_size, p),
            padded(y).reshape(nb, batch_size),
            padded(sw).reshape(nb, batch_size))


def _to_device(batches, dev: torch.device):
    idx, val, y, sw = batches
    return (torch.as_tensor(np.ascontiguousarray(idx)).to(dev, torch.int64),
            torch.as_tensor(np.ascontiguousarray(val)).to(dev),
            torch.as_tensor(np.ascontiguousarray(y)).to(dev),
            torch.as_tensor(np.ascontiguousarray(sw)).to(dev))


def _run_batches(state: VWState, batches, cfg: VWConfig, lo: int, hi: int,
                 preds: Optional[torch.Tensor] = None) -> None:
    """Batches ``lo:hi`` of the (nb, B, ...) device stack through ``_step``;
    each batch's predictions into ``preds[b]`` when given."""
    idx, val, y, sw = batches
    for b in range(lo, hi):
        p = _step(state, idx[b], val[b], y[b], sw[b], cfg)
        if preds is not None:
            preds[b] = p


def _average(state: VWState, group) -> None:
    """The JAX package's segment-end ``pmean`` / ``psum`` over the data
    axis, in place: weights, accumulator, bias, bias accumulator and
    example counter averaged; the progressive sums summed."""
    from ..parallel.collectives import allreduce_mean, allreduce_sum

    for k in ("weights", "acc", "bias", "bias_acc", "t"):
        getattr(state, k).copy_(allreduce_mean(getattr(state, k), group))
    for k in ("loss_sum", "weight_sum"):
        getattr(state, k).copy_(allreduce_sum(getattr(state, k), group))


def train_vw(idx: np.ndarray, val: np.ndarray, y: np.ndarray,
             cfg: VWConfig, sample_weight: Optional[np.ndarray] = None,
             mesh=None, initial_state: Optional[VWState] = None,
             collect_progressive: bool = False, device=None):
    """Train; returns (VWState, progressive_predictions | None).

    idx/val: (N, P) int32/f32 padded sparse rows; y: (N,) — for logistic/hinge
    losses callers must pass labels in ±1. The pass runs on ``device``
    (default: ``initial_state``'s device, else the mesh's, else the card);
    ``initial_state`` is copied, never updated in place.

    With ``mesh`` the rows split over its ``data`` axis, each rank running
    its block, and the state is averaged over the axis after each of
    ``cfg.sync_splits`` segments of a pass (one segment when the rank's
    batch count does not split evenly). Single controller
    (``init_distributed``): every rank passes the same whole table.
    Multi-controller (``initialize_distributed``): each process passes its
    own rows, the same row count and width on every process."""
    if device is None:
        device = (initial_state.device if initial_state is not None
                  else mesh.device if mesh is not None else DEFAULT_DEVICE)
    dev = resolve_device(device)
    n = idx.shape[0]
    _check_indices(np.asarray(idx), 1 << cfg.num_bits)
    sw = (np.ones(n, np.float32) if sample_weight is None
          else np.asarray(sample_weight, np.float32))
    state = (initial_state.to(dev) if initial_state is not None
             else VWState.init(cfg.num_bits, dev))
    progressive = None

    if mesh is None:
        batches = _to_device(
            _pack(np.asarray(idx, np.int32), np.asarray(val, np.float32),
                  np.asarray(y, np.float32), sw, cfg.batch_size), dev)
        nb = batches[0].shape[0]
        for p in range(cfg.num_passes):
            keep = collect_progressive and p == 0
            preds = (torch.empty(nb, cfg.batch_size, device=dev) if keep
                     else None)
            _run_batches(state, batches, cfg, 0, nb, preds)
            if keep:
                progressive = preds.reshape(-1)[:n].cpu().numpy()
        return state, progressive

    from ..parallel.mesh import (assert_equal_across_processes,
                                 local_mesh_devices, process_count, row_block)

    multiproc = process_count() > 1
    local_dev = local_mesh_devices(mesh)
    if multiproc:
        # feature width is data-derived (parse_lines pads to the local
        # max), so it must match too or the segments desynchronize
        assert_equal_across_processes(
            (n, idx.shape[1]), "local row count / padded feature width")
    # equal local row counts per device, then equal local batch counts
    # (multiproc: n and the padding are per-PROCESS over its local devices)
    per = -(-n // local_dev)
    per = -(-per // cfg.batch_size) * cfg.batch_size

    def shard_pad(a, fill=0):
        pad = per * local_dev - a.shape[0]
        width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill) if pad else a

    nb_local = per // cfg.batch_size
    p_dim = idx.shape[1]
    batches = (
        shard_pad(np.asarray(idx, np.int32)).reshape(
            local_dev * nb_local, cfg.batch_size, p_dim),
        shard_pad(np.asarray(val, np.float32)).reshape(
            local_dev * nb_local, cfg.batch_size, p_dim),
        shard_pad(np.asarray(y, np.float32)).reshape(
            local_dev * nb_local, cfg.batch_size),
        shard_pad(sw).reshape(local_dev * nb_local, cfg.batch_size))
    if multiproc:
        # the global batch stack is the processes' stacks in process order;
        # this process's rank holds its own block
        nprocs = process_count()
        lo, hi = row_block(nprocs * batches[0].shape[0], mesh)
        own = lo // batches[0].shape[0]
        if hi - lo != batches[0].shape[0] or own != mesh.rank:
            raise NotImplementedError(
                "train_vw(mesh=) across processes takes a data-only mesh of "
                "one rank per process")
    else:
        lo, hi = row_block(batches[0].shape[0], mesh)
        batches = tuple(b[lo:hi] for b in batches)
    batches = _to_device(batches, dev)
    group = mesh.group(DATA_AXIS)
    nb = batches[0].shape[0]
    s = cfg.sync_splits if nb % cfg.sync_splits == 0 else 1
    seg = nb // s
    for _ in range(cfg.num_passes):
        for k in range(s):
            _run_batches(state, batches, cfg, k * seg, (k + 1) * seg)
            _average(state, group)
    return state, progressive


def vw_predict(state: VWState, idx, val, link: str = "identity") -> np.ndarray:
    """Raw (or ``link="logistic"``: sigmoid) predictions of ``state`` on
    padded sparse rows, computed on the state's device."""
    dev = state.device
    idx = np.asarray(idx)
    _check_indices(idx, state.weights.shape[0])
    p = _raw_predict(
        state.weights, state.bias,
        torch.as_tensor(np.ascontiguousarray(idx, np.int32)).to(dev, torch.int64),
        torch.as_tensor(np.ascontiguousarray(val, np.float32)).to(dev))
    if link == "logistic":
        p = torch.sigmoid(p)
    return p.cpu().numpy()
