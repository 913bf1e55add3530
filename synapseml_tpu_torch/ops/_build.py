"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. The build
happens at first use, inside the checkout (``build/synapseml_tpu_torch/``,
listed in ``.gitignore``), from the sources in the repository alone. A
library's file name carries a digest of its source and flags, so an edited
source is rebuilt and a stale library is never loaded. ``build_all`` starts
one ``nvcc`` per source, all at once.

Nothing here runs when a module is imported: the CPU tests import every
module on a machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "synapseml_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library exists; returns
    (process or None, temp path, final path)."""
    out = _lib_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path, t0: float) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build_all(names=None) -> dict:
    """Compile every named source (default: all of ``csrc/``) with one nvcc
    process each, started together; returns {name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else names
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    for n, (proc, tmp, out) in started.items():
        _finish(n, proc, tmp, out, t0)
    return {n: out for n, (_, _, out) in started.items()}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built first if needed),
    with ``signatures`` = {function: (argtypes, restype)} applied."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _LIBS[name] = lib
        return lib
