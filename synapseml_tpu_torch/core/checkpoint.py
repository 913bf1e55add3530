"""Crash-safe checkpoint store for GBDT training resume.

A copy of the part of the JAX package's ``core/checkpoint.py`` that
``train_booster``'s resume needs: the error types, atomic writes, the
manifest-verified keep-last-N :class:`CheckpointStore` (with the content
digest and version id that the serving model registry keys hot swaps on)
and the cooperative :func:`preemption_point` hook. The sharded pytree checkpoints and the
non-finite loss guard are not copied.

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
import zlib
from typing import Any, Callable, Dict, List, Optional

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
             meta: Optional[Dict[str, Any]] = None) -> str:
        """Persist one checkpoint; returns its base name. The manifest
        rename is the commit point; retention prunes only after it."""
        if not artifacts:
            raise ValueError("checkpoint needs at least one artifact")
        for name in artifacts:
            if os.sep in name or name.startswith(".") or not name:
                raise ValueError(f"bad artifact name {name!r}")
        os.makedirs(self.dir, exist_ok=True)
        base = self._base(int(step))
        manifest = {"format": 1, "step": int(step), "meta": meta or {},
                    "artifacts": {}}
        for name, data in artifacts.items():
            atomic_write_bytes(self._artifact_path(base, name), bytes(data))
            manifest["artifacts"][name] = _digests(bytes(data))
        atomic_write_text(self._manifest_path(base),
                          json.dumps(manifest, sort_keys=True))
        atomic_write_text(os.path.join(self.dir, "latest"), base)
        self._prune()
        return base

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

    def _load_base(self, base: str) -> Checkpoint:
        """Read and verify one checkpoint; raises CheckpointError on any
        integrity failure."""
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
            arts[name] = data
        return Checkpoint(step=int(manifest.get("step", -1)), artifacts=arts,
                          meta=manifest.get("meta", {}) or {}, base=base)

    def load_step(self, step: int) -> Checkpoint:
        """The checkpoint of ``step``, verified; raises CheckpointError."""
        return self._load_base(self._base(int(step)))

    def load_latest(self) -> Optional[Checkpoint]:
        """Newest checkpoint that verifies, or None. A corrupt newest
        checkpoint is counted (``checkpoint.corrupt``) and recovery falls
        back to the previous good one (``checkpoint.fallback``)."""
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
                ckpt = self._load_base(base)
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
