"""Crash-safe checkpoint store, sharded state checkpoints and the
non-finite loss guard.

Counterpart of the JAX package's ``core/checkpoint.py``: the error types,
atomic writes, the manifest-verified keep-last-N :class:`CheckpointStore`
(with the content digest and version id that the serving model registry
keys hot swaps on), the cooperative :func:`preemption_point` hook,
:class:`NonFiniteGuard`, and the sharded tree format of
:func:`save_sharded_tree` / :func:`load_sharded_from_checkpoint` over the
ranks of a ``torch.distributed`` world.

* **Atomic writes**: every artifact lands via tmp + ``os.replace``; the
  manifest is written last, so a checkpoint without a verifiable manifest
  never existed as far as recovery is concerned.
* **Integrity manifest**: per-artifact size, CRC32 and SHA-256; a torn or
  flipped artifact is detected at load (``checkpoint.corrupt``), not
  deserialized.
* **Keep-last-N retention**: older steps are pruned only after a new step
  is durable.
* **Corruption fallback**: ``load_latest`` returns the newest checkpoint
  that verifies (``checkpoint.fallback``).

Layout (flat, one manifest per step)::

    dir/
      ckpt_00000007.state.pkl
      ckpt_00000007.manifest.json    # digests; presence == checkpoint valid
      latest                         # basename of the newest step
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .logging import record_failure

MANIFEST_SUFFIX = ".manifest.json"
_STEP_RE = re.compile(r"^(?P<prefix>[A-Za-z0-9]+)_(?P<step>\d{8})$")


class CheckpointError(ValueError):
    """A checkpoint could not be read/verified (corrupt, torn, missing)."""


class PreemptionError(BaseException):
    """An injected (or cooperative) preemption: the process is being killed.

    Derives from ``BaseException`` so generic ``except Exception`` recovery
    code cannot swallow a kill, as a real SIGTERM would not be swallowable.
    """


# --- atomic primitives ------------------------------------------------------

def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically (tmp + rename in one dir)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def _check_name(name: str) -> None:
    if os.sep in name or name.startswith(".") or not name:
        raise ValueError(f"bad artifact name {name!r}")


def _digests(data: bytes) -> Dict[str, Any]:
    return {"size": len(data),
            "crc32": zlib.crc32(data) & 0xFFFFFFFF,
            "sha256": hashlib.sha256(data).hexdigest()}


# --- the store --------------------------------------------------------------

@dataclasses.dataclass
class Checkpoint:
    """One verified checkpoint: step number, artifact bytes by name, and the
    free-form ``meta`` dict the saver attached."""
    step: int
    artifacts: Dict[str, bytes]
    meta: Dict[str, Any]
    base: str      # e.g. "ckpt_00000007" (for diagnostics)

    @property
    def digest(self) -> str:
        """Content digest of the whole checkpoint: SHA-256 over the sorted
        per-artifact (name, sha256) pairs. Two checkpoints with identical
        bytes share a digest regardless of step number — the identity the
        serving model registry keys hot-swap versions on."""
        h = hashlib.sha256()
        for name in sorted(self.artifacts):
            h.update(name.encode("utf-8"))
            h.update(b"\x00")
            h.update(hashlib.sha256(self.artifacts[name]).hexdigest()
                     .encode("ascii"))
            h.update(b"\x00")
        return h.hexdigest()

    @property
    def version(self) -> str:
        """Version id (``<base>@<digest12>``) for the serving model
        registry: names the step AND pins the exact bytes, so a re-written
        step with different content is a different version."""
        return f"{self.base}@{self.digest[:12]}"


class CheckpointStore:
    """Atomic, manifest-verified, keep-last-N checkpoint directory. One
    writer per store."""

    def __init__(self, directory: str, keep_last: int = 3,
                 prefix: str = "ckpt"):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        if not re.fullmatch(r"[A-Za-z0-9]+", prefix):
            raise ValueError(f"prefix must be alphanumeric, got {prefix!r}")
        self.dir = directory
        self.keep_last = keep_last
        self.prefix = prefix

    def _base(self, step: int) -> str:
        return f"{self.prefix}_{step:08d}"

    def _manifest_path(self, base: str) -> str:
        return os.path.join(self.dir, base + MANIFEST_SUFFIX)

    def _artifact_path(self, base: str, name: str) -> str:
        return os.path.join(self.dir, f"{base}.{name}")

    def save(self, step: int, artifacts: Dict[str, bytes],
             meta: Optional[Dict[str, Any]] = None,
             extra_digests: Optional[Dict[str, Dict[str, Any]]] = None
             ) -> str:
        """Persist one checkpoint; returns its base name. The manifest
        rename is the commit point; retention prunes only after it.
        ``extra_digests`` lists artifacts other ranks wrote with
        :meth:`save_artifact_only` before this call, so the manifest covers
        them without this rank holding their bytes."""
        if not artifacts:
            raise ValueError("checkpoint needs at least one artifact")
        for name in list(artifacts) + list(extra_digests or {}):
            _check_name(name)
        os.makedirs(self.dir, exist_ok=True)
        base = self._base(int(step))
        manifest = {"format": 1, "step": int(step), "meta": meta or {},
                    "artifacts": dict(extra_digests or {})}
        for name, data in artifacts.items():
            atomic_write_bytes(self._artifact_path(base, name), bytes(data))
            manifest["artifacts"][name] = _digests(bytes(data))
        atomic_write_text(self._manifest_path(base),
                          json.dumps(manifest, sort_keys=True))
        atomic_write_text(os.path.join(self.dir, "latest"), base)
        self._prune()
        return base

    def save_artifact_only(self, step: int, name: str,
                           data: bytes) -> Dict[str, Any]:
        """Atomically write ONE artifact of ``step`` without a manifest and
        return its digests: each rank of a sharded checkpoint lands its own
        shard file this way, then rank 0 commits the manifest through
        ``save(..., extra_digests=...)``."""
        _check_name(name)
        os.makedirs(self.dir, exist_ok=True)
        atomic_write_bytes(self._artifact_path(self._base(int(step)), name),
                           bytes(data))
        return _digests(bytes(data))

    def _prune(self) -> None:
        for step in self.steps()[:-self.keep_last]:
            base = self._base(step)
            for fn in os.listdir(self.dir):
                if fn == base + MANIFEST_SUFFIX or fn.startswith(base + "."):
                    try:
                        os.remove(os.path.join(self.dir, fn))
                    except OSError:
                        pass   # a vanished file is already pruned

    def steps(self) -> List[int]:
        """Ascending step numbers that have a manifest on disk."""
        if not os.path.isdir(self.dir):
            return []
        out = []
        for fn in os.listdir(self.dir):
            if not fn.endswith(MANIFEST_SUFFIX):
                continue
            m = _STEP_RE.match(fn[: -len(MANIFEST_SUFFIX)])
            if m and m.group("prefix") == self.prefix:
                out.append(int(m.group("step")))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _load_base(self, base: str,
                   artifact_filter: Optional[Callable[[str], bool]] = None
                   ) -> Checkpoint:
        """Read and verify one checkpoint; raises CheckpointError on any
        integrity failure. Every artifact is verified; ``artifact_filter``
        only says which artifacts' bytes are kept."""
        mpath = self._manifest_path(base)
        try:
            with open(mpath, "rb") as f:
                manifest = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError) as e:
            raise CheckpointError(f"checkpoint {base}: unreadable manifest "
                                  f"({e})") from e
        if not manifest.get("artifacts"):
            raise CheckpointError(f"checkpoint {base}: empty manifest")
        arts: Dict[str, bytes] = {}
        for name, want in manifest["artifacts"].items():
            try:
                with open(self._artifact_path(base, name), "rb") as f:
                    data = f.read()
            except OSError as e:
                raise CheckpointError(
                    f"checkpoint {base}: artifact {name!r} missing "
                    f"({e})") from e
            got = _digests(data)
            for field in ("size", "crc32", "sha256"):
                if got[field] != want.get(field):
                    raise CheckpointError(
                        f"checkpoint {base}: artifact {name!r} failed "
                        f"{field} verification (torn write or bit rot): "
                        f"expected {want.get(field)!r}, got {got[field]!r}")
            if artifact_filter is None or artifact_filter(name):
                arts[name] = data
        return Checkpoint(step=int(manifest.get("step", -1)), artifacts=arts,
                          meta=manifest.get("meta", {}) or {}, base=base)

    def load_step(self, step: int,
                  artifact_filter: Optional[Callable[[str], bool]] = None
                  ) -> Checkpoint:
        """The checkpoint of ``step``, verified; raises CheckpointError."""
        return self._load_base(self._base(int(step)), artifact_filter)

    def load_latest(self,
                    artifact_filter: Optional[Callable[[str], bool]] = None
                    ) -> Optional[Checkpoint]:
        """Newest checkpoint that verifies, or None. A corrupt newest
        checkpoint is counted (``checkpoint.corrupt``) and recovery falls
        back to the previous good one (``checkpoint.fallback``).
        ``artifact_filter`` bounds which artifacts' bytes are kept."""
        if not os.path.isdir(self.dir):
            return None
        candidates: List[str] = []
        latest_path = os.path.join(self.dir, "latest")
        pointed = None
        if os.path.exists(latest_path):
            try:
                with open(latest_path) as f:
                    pointed = f.read().strip()
            except OSError:
                pointed = None
        if pointed:
            candidates.append(pointed)
        for step in reversed(self.steps()):
            base = self._base(step)
            if base not in candidates:
                candidates.append(base)
        first_failure = None
        for i, base in enumerate(candidates):
            try:
                ckpt = self._load_base(base, artifact_filter)
            except CheckpointError as e:
                record_failure("checkpoint.corrupt", base=base, error=str(e))
                if first_failure is None:
                    first_failure = str(e)
                continue
            if i > 0 or first_failure is not None:
                record_failure("checkpoint.fallback", base=base,
                               skipped=i, first_error=first_failure)
            return ckpt
        return None


# --- preemption points ------------------------------------------------------
# Training loops call preemption_point(phase, step) at every resume-safe
# boundary. Normally a no-op; a test installs a hook (``_PREEMPT_HOOK``) that
# raises PreemptionError on its schedule.

_PREEMPT_HOOK: Optional[Callable[[str, int], None]] = None


def preemption_point(phase: str, step: int) -> None:
    """A resume-safe boundary in a training loop. ``phase`` is a dotted name
    (``gbdt.iteration``); ``step`` is the loop index about to run."""
    hook = _PREEMPT_HOOK
    if hook is not None:
        hook(phase, step)


# --- non-finite loss guard --------------------------------------------------

class NonFiniteLossError(FloatingPointError):
    """Raised by NonFiniteGuard(policy='raise') on a NaN/inf training loss."""


class NonFiniteGuard:
    """Policy on non-finite training losses.

    * ``raise``: stop with :class:`NonFiniteLossError`.
    * ``skip``: drop the poisoned step (the caller reverts to its pre-step
      state) and go on; after ``max_consecutive`` consecutive skips the
      guard raises, so a run that stays NaN cannot spin.
    * ``rollback``: the caller restores the last good checkpoint; after
      ``max_rollbacks`` rollbacks the guard raises.

    Every event counts ``train.nonfinite_loss`` and, per policy,
    ``train.nonfinite_skipped`` or ``train.nonfinite_rollback`` through
    :func:`core.logging.record_failure`."""

    POLICIES = ("raise", "skip", "rollback")

    def __init__(self, policy: str = "raise", max_consecutive: int = 10,
                 max_rollbacks: int = 3, counter_prefix: str = "train"):
        if policy not in self.POLICIES:
            raise ValueError(f"NonFiniteGuard policy={policy!r} is not one "
                             f"of {self.POLICIES}")
        self.policy = policy
        self.max_consecutive = max_consecutive
        self.max_rollbacks = max_rollbacks
        self.prefix = counter_prefix
        self.consecutive = 0
        self.total = 0
        self.rollbacks = 0

    def check(self, loss: float, step: int) -> str:
        """``"ok"``, ``"skip"`` (the caller reverts the step) or
        ``"rollback"`` (the caller restores the last checkpoint); raises
        :class:`NonFiniteLossError` per policy."""
        import math

        if math.isfinite(loss):
            self.consecutive = 0
            return "ok"
        self.total += 1
        self.consecutive += 1
        record_failure(f"{self.prefix}.nonfinite_loss", step=int(step),
                       loss=repr(loss), policy=self.policy)
        if self.policy == "raise":
            raise NonFiniteLossError(
                f"non-finite training loss ({loss!r}) at step {step}; set "
                "the non-finite policy to 'skip' or 'rollback' to continue "
                "past poisoned steps")
        if self.policy == "skip":
            if self.consecutive > self.max_consecutive:
                raise NonFiniteLossError(
                    f"{self.consecutive} consecutive non-finite losses "
                    f"(last at step {step}); the run is not recovering — "
                    "check learning rate / data for inf/NaN")
            record_failure(f"{self.prefix}.nonfinite_skipped", step=int(step))
            return "skip"
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise NonFiniteLossError(
                f"non-finite loss persisted through {self.max_rollbacks} "
                f"checkpoint rollbacks (last at step {step}); aborting")
        record_failure(f"{self.prefix}.nonfinite_rollback", step=int(step),
                       rollback=self.rollbacks)
        return "rollback"


# --- trees in jax.tree_util's order -----------------------------------------
# A tree is nested dicts, lists, tuples and namedtuples; anything else is a
# leaf, None is an empty subtree. Leaves are visited as jax.tree_util visits
# them (dict keys sorted, namedtuple fields in order) and named by its
# ``keystr`` (``['opt_state'][0].mu['head']['kernel']``), so a manifest
# written here lists the JAX package's trainer state leaf for leaf.

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """[(key string, child)] in jax's flatten order, or None for a leaf."""
    if _is_namedtuple(node):
        return [(f".{k}", getattr(node, k)) for k in node._fields]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def tree_flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr, leaf)] of ``tree`` in ``jax.tree_util`` order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += tree_flatten_with_path(child, prefix + key)
    return out


def tree_unflatten(tree, leaves):
    """``tree``'s structure (dict key order kept) holding ``leaves`` in
    ``tree_flatten_with_path``'s order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            got = {k: build(node[k]) for k in sorted(node)}
            return {k: got[k] for k in node}
        vals = [build(v) for _, v in kids]
        if _is_namedtuple(node):
            return type(node)(*vals)
        return vals if isinstance(node, list) else tuple(vals)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


# --- sharded tree checkpoints -----------------------------------------------
# The JAX package's format (one checkpoint step):
#   <prefix>.sharding.json    format 1: per leaf its path, global shape,
#                             dtype and blocks, each block naming (artifact,
#                             npz key, [start, stop] per dim)
#   <prefix>.shards_p<R>.npz  rank R's blocks, one uint8 buffer each (raw
#                             bytes, so bfloat16 round-trips bitwise)
# A replicated leaf is one block, written by rank 0; a sharded leaf one
# block per distinct window, each written by the lowest rank holding it.
# Restore assembles the window each rank asks for from whatever blocks
# cover it, so a checkpoint of one world restores onto another.

@dataclasses.dataclass
class LocalBlock:
    """This rank's block of a leaf sharded over the ranks (the counterpart
    of one addressable shard of a ``jax.Array``): the block's ``data``,
    the leaf's global ``shape``, the block's window ``index`` ((start,
    stop) per dim) and whether this rank writes it (``owner``: the lowest
    rank holding the window)."""
    data: Any
    shape: tuple
    index: tuple
    owner: bool = True


def _norm_index(idx, shape) -> tuple:
    """A tuple of slices (possibly open) as ((start, stop), ...)."""
    out = []
    for i, sl in enumerate(idx):
        s = 0 if sl.start is None else int(sl.start)
        e = shape[i] if sl.stop is None else int(sl.stop)
        out.append((s, e))
    return tuple(out)


def _world(group=None) -> Tuple[int, int]:
    """(rank, size) within ``group`` (None: the default group), (0, 1)
    without an initialised world."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def _exchange_json(obj, timeout: Optional[float] = None, group=None):
    """Every rank's JSON-serialisable ``obj``, in rank order (``[obj]``
    without a world): ``all_gather_object`` over ``group`` (None: the
    default group). It is also the
    barrier that orders every rank's shard write before rank 0 commits the
    manifest. ``timeout`` (default env ``SYNAPSEML_BARRIER_TIMEOUT_S``,
    300 s; <= 0 waits forever) turns a dead or hung peer into
    ``CheckpointError("barrier timeout, peers=[...]")``."""
    import torch.distributed as dist

    rank, world = _world(group)
    if world == 1:
        return [obj]
    raw = json.loads(json.dumps(obj, sort_keys=True))

    def _gather():
        out = [None] * world
        dist.all_gather_object(out, raw, group=group)
        return out

    if timeout is None:
        timeout = float(os.environ.get("SYNAPSEML_BARRIER_TIMEOUT_S", "300"))
    if timeout <= 0:
        return _gather()
    box: Dict[str, Any] = {}
    done = threading.Event()

    def _run():
        try:
            box["out"] = _gather()
        except BaseException as e:  # noqa: BLE001 - relayed to the caller
            box["err"] = e
        finally:
            done.set()

    threading.Thread(target=_run, daemon=True, name="ckpt-barrier").start()
    if not done.wait(timeout):
        peers = [p for p in range(world) if p != rank]
        record_failure("checkpoint.barrier_timeout", peers=peers,
                       timeout_s=timeout)
        raise CheckpointError(
            f"barrier timeout, peers={peers}: a peer died or hung before "
            f"the pre-manifest exchange completed ({timeout:.1f}s)")
    if "err" in box:
        raise box["err"]
    return box["out"]


def _raw(x) -> Tuple[tuple, str, bytes]:
    from .serialization import _array_parts

    if isinstance(x, (torch.Tensor, np.ndarray)):
        return _array_parts(x)
    return _array_parts(np.asarray(x))


def save_sharded_tree(store: CheckpointStore, step: int, tree,
                      meta: Optional[Dict[str, Any]] = None,
                      prefix: str = "state", group=None) -> str:
    """Save ``tree`` (leaves: full arrays or tensors, replicated on every
    rank, or :class:`LocalBlock`s) as one shard artifact per rank plus the
    ``<prefix>.sharding.json`` manifest; returns the checkpoint base. Every
    rank of ``group`` (None: the world) calls it, ranks numbered within
    it. Ranks other than 0 land their artifact
    first; after an exchange of digests rank 0 commits the manifest, and a
    second exchange holds every rank until the commit is on disk."""
    import io

    rank, world = _world(group)
    shard_name = f"{prefix}.shards_p{rank}.npz"
    blocks_out: Dict[str, np.ndarray] = {}
    mine, heads = [], []
    for li, (path, leaf) in enumerate(tree_flatten_with_path(tree)):
        if isinstance(leaf, LocalBlock):
            shape = tuple(int(d) for d in leaf.shape)
            bshape, dtype, buf = _raw(leaf.data)
            index = [[int(s), int(e)] for s, e in leaf.index]
            if tuple(e - s for s, e in index) != tuple(bshape):
                raise ValueError(f"leaf {path}: block of shape {bshape} "
                                 f"does not fill its window {index}")
            write = leaf.owner
        else:
            shape, dtype, buf = _raw(leaf)
            index = [[0, d] for d in shape]
            write = rank == 0
        blocks = []
        if write:
            key = f"l{li}_b0"
            blocks_out[key] = np.frombuffer(buf, np.uint8)
            blocks.append({"artifact": shard_name, "key": key,
                           "index": index})
        mine.append(blocks)
        heads.append({"path": path, "shape": list(shape), "dtype": dtype})
    bio = io.BytesIO()
    np.savez(bio, **blocks_out)
    npz = bio.getvalue()
    extra = None
    merged = mine
    if world > 1:
        digests = (store.save_artifact_only(step, shard_name, npz)
                   if rank else _digests(npz))
        payloads = _exchange_json({"artifact": shard_name,
                                   "digests": digests, "leaves": mine},
                                  group=group)
        merged = [sum((pl["leaves"][li] for pl in payloads), [])
                  for li in range(len(heads))]
        extra = {pl["artifact"]: pl["digests"] for pl in payloads[1:]}
    base = store._base(int(step))
    if rank == 0:
        manifest = {"format": 1, "prefix": prefix, "processes": world,
                    "leaves": [dict(h, blocks=b)
                               for h, b in zip(heads, merged)]}
        base = store.save(int(step), {
            f"{prefix}.sharding.json": json.dumps(
                manifest, sort_keys=True).encode("utf-8"),
            shard_name: npz}, meta=meta, extra_digests=extra)
    if world > 1:
        _exchange_json(base, group=group)
    return base


def _leaf_head(leaf) -> Tuple[tuple, str, Optional[tuple]]:
    """(global shape, dtype name, window or None) a template leaf asks for."""
    from .serialization import _TORCH_NAMES

    if isinstance(leaf, LocalBlock):
        shape, dtype, _ = _leaf_head(leaf.data)
        return (tuple(int(d) for d in leaf.shape), dtype,
                tuple((int(s), int(e)) for s, e in leaf.index))
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), _TORCH_NAMES[leaf.dtype], None
    a = np.asarray(leaf)
    return a.shape, a.dtype.name, None


def _storage_dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def load_sharded_from_checkpoint(store: CheckpointStore, ckpt: Checkpoint,
                                 template, prefix: str = "state"):
    """Restore the tree :func:`save_sharded_tree` saved (by either package)
    from an already located checkpoint (``ckpt`` needs only the manifest).
    ``template`` fixes the structure and each leaf's global shape and
    dtype (a mismatch raises :class:`CheckpointError` naming the leaf); a
    :class:`LocalBlock` leaf asks for its window only (an empty window,
    nothing: a pipeline stage this rank does not hold), any other leaf for
    the whole array. Only the shard artifacts that overlap a wanted window
    are read. Leaves come back as CPU tensors."""
    import io

    mname = f"{prefix}.sharding.json"
    mbytes = ckpt.artifacts.get(mname)
    if mbytes is None:
        raise CheckpointError(
            f"checkpoint {ckpt.base}: no sharded-tree manifest {mname!r}")
    entries = json.loads(mbytes.decode("utf-8"))["leaves"]
    tleaves = [leaf for _, leaf in tree_flatten_with_path(template)]
    if len(entries) != len(tleaves):
        raise CheckpointError(
            f"checkpoint {ckpt.base}: saved tree has {len(entries)} leaves, "
            f"template has {len(tleaves)} — the model/optimizer structure "
            "changed since it was saved")
    wins = []
    for entry, tl in zip(entries, tleaves):
        shape, dtype, win = _leaf_head(tl)
        if tuple(entry["shape"]) != tuple(shape):
            raise CheckpointError(
                f"checkpoint {ckpt.base}: leaf {entry['path']} has shape "
                f"{tuple(entry['shape'])}, model expects {tuple(shape)}")
        if entry["dtype"] != dtype:
            raise CheckpointError(
                f"checkpoint {ckpt.base}: leaf {entry['path']} has dtype "
                f"{entry['dtype']}, model expects {dtype}")
        wins.append(win or tuple((0, d) for d in shape))

    def overlap(win, bidx):
        return [(max(s1, s2), min(e1, e2))
                for (s1, e1), (s2, e2) in zip(win, bidx)]

    def hits(win, bidx):
        if any(s1 == e1 for s1, e1 in win):
            return False        # an empty window needs no block
        return all(s < e for s, e in overlap(win, bidx))

    needed = {blk["artifact"] for entry, win in zip(entries, wins)
              for blk in entry["blocks"] if hits(win, blk["index"])}
    full = store.load_step(ckpt.step, artifact_filter=lambda n: n in needed)
    npzs = {name: np.load(io.BytesIO(data), allow_pickle=False)
            for name, data in full.artifacts.items()}
    out = []
    for entry, win in zip(entries, wins):
        dt = _storage_dtype(entry["dtype"])
        wshape = tuple(e - s for s, e in win)
        arr = np.zeros(wshape, dt)
        if arr.size == 0:
            # a window this rank does not hold (a stage group it is not in)
            out.append(torch.from_numpy(arr).view(torch.bfloat16)
                       if entry["dtype"] == "bfloat16"
                       else torch.from_numpy(arr))
            continue
        covered = 0
        for blk in entry["blocks"]:
            bidx = [tuple(b) for b in blk["index"]]
            inter = overlap(win, bidx)
            if any(s >= e for s, e in inter):
                continue
            if blk["artifact"] not in npzs:
                raise CheckpointError(
                    f"checkpoint {ckpt.base}: block in {blk['artifact']!r} "
                    "needed but its artifact was not loaded")
            data = np.frombuffer(npzs[blk["artifact"]][blk["key"]].tobytes(),
                                 dt).reshape(tuple(e - s for s, e in bidx))
            src = tuple(slice(s - b0, e - b0)
                        for (s, e), (b0, _) in zip(inter, bidx))
            dst = tuple(slice(s - w0, e - w0)
                        for (s, e), (w0, _) in zip(inter, win))
            arr[dst] = data[src]
            covered += int(np.prod([e - s for s, e in inter]))
        if covered != arr.size:
            raise CheckpointError(
                f"checkpoint {ckpt.base}: leaf {entry['path']} window {win} "
                f"only {covered}/{arr.size} elements covered — a shard "
                "artifact from another rank is missing")
        t = torch.from_numpy(arr)
        out.append(t.view(torch.bfloat16) if entry["dtype"] == "bfloat16"
                   else t)
    return tree_unflatten(template, out)


def load_sharded_tree(store: CheckpointStore, template,
                      prefix: str = "state"):
    """``(tree, step, meta)`` of the newest verified sharded checkpoint, or
    None when the store holds none."""
    mname = f"{prefix}.sharding.json"
    ckpt = store.load_latest(artifact_filter=lambda n: n == mname)
    if ckpt is None or mname not in ckpt.artifacts:
        return None
    return (load_sharded_from_checkpoint(store, ckpt, template, prefix),
            ckpt.step, ckpt.meta)
