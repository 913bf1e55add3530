"""GBDT histogram kernels — hand-written CUDA for Hopper, plain PyTorch beside.

Counterpart of the JAX package's ``ops/hist_kernel.py``, with its public
names and layouts: bins ``bT`` are ``(FP, n)`` int32 (features padded to
``features_padded(F)``), ``g``/``h``/``m`` are ``(n,)`` float32, and the
result is the ``(FP, B, 3)`` float32 histogram of [sum g, sum h, sum m] with
``B = pad_bins(max_bin)``. g, h and m are rounded to bf16 before the float32
sum and bins outside ``[0, B)`` are dropped — the reference's contract.

* ``child_histogram`` ← ``_kernel``/``_packed_accumulate`` via ``_hist_pallas``
* ``range_histogram`` ← ``_range_kernel`` via ``_hist_pallas_range``
* ``level_histograms`` ← ``_level_kernel`` via ``_hist_pallas_level``

All three run ``csrc/hist_kernel.cu`` for CUDA tensors (one launch each,
counted in ``LAUNCHES``) and the plain versions ``_hist_plain`` /
``_range_hist_plain`` / ``_level_hist_plain`` for CPU tensors. A CUDA tensor
never falls back to the plain version: the kernel launches or the call
raises. Kernels and plain versions take every bin space ``pad_bins`` makes:
the kernels sum a large one in bin windows (16384 bins for the leaf-wise
kernels, 2048 for the level kernel) on a grid axis of one launch.
"""

from __future__ import annotations

import ctypes

import torch

FEATURE_BLOCK = 8
# rows per chunk of the level kernel's slot-partitioned layout (the depthwise
# grower aligns every leaf's rows to it)
CHUNK = 2048

# launches of each hand-written kernel (incremented only where it launches)
LAUNCHES = {"child_histogram": 0, "range_histogram": 0, "level_histograms": 0}

_P = ctypes.c_void_p
_SIGNATURES = {
    "child_histogram": ([_P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_int, _P], ctypes.c_int),
    "range_histogram": ([_P, _P, _P, _P, _P, _P, ctypes.c_int64,
                         ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
    "level_histogram": ([_P, _P, _P, _P, _P, _P, ctypes.c_int64,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, _P], ctypes.c_int),
}


def pad_bins(max_bin: int) -> int:
    """Histogram bin-space size: power of two >= max_bin, at least 256."""
    b = 256
    while b < max_bin:
        b *= 2
    return b


def features_padded(f: int) -> int:
    return -(-f // FEATURE_BLOCK) * FEATURE_BLOCK


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from . import _build

    return _build.load("hist_kernel", _SIGNATURES)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------

def _rounded_values(g, h, m) -> torch.Tensor:
    vals = torch.stack([g, h, m], -1).to(torch.float32)
    return vals.to(torch.bfloat16).to(torch.float32)           # (n, 3)


def _hist_plain(bT, g, h, m, num_bins_padded: int) -> torch.Tensor:
    """bf16-rounded ``index_add_`` over (feature, bin) slots; out-of-range
    bins go to a spare slot that is cut off (mode="drop")."""
    FP, n = bT.shape
    B = num_bins_padded
    vals = _rounded_values(g, h, m)
    b = bT.to(torch.int64)
    flat = b + torch.arange(FP, device=bT.device, dtype=torch.int64)[:, None] * B
    flat = torch.where((b >= 0) & (b < B), flat, FP * B)
    out = torch.zeros((FP * B + 1, 3), dtype=torch.float32, device=bT.device)
    out.index_add_(0, flat.reshape(-1), vals.expand(FP, n, 3).reshape(-1, 3))
    return out[:FP * B].reshape(FP, B, 3)


def _range_hist_plain(bT, g, h, m, start, length,
                      num_bins_padded: int) -> torch.Tensor:
    """Histogram of rows [start, start+length) of the full arrays."""
    n = bT.shape[1]
    s = min(max(int(start), 0), n)
    e = min(s + max(int(length), 0), n)
    return _hist_plain(bT[:, s:e], g[s:e], h[s:e], m[s:e], num_bins_padded)


def _level_hist_plain(bT, g, h, m, slot_of_row, num_bins_padded: int,
                      slots: int) -> torch.Tensor:
    """(slots, FP, B, 3) histograms of every slot: one bf16-rounded
    ``index_add_`` keyed by (slot of the row, feature, bin); out-of-range
    bins and slots go to a spare row that is cut off."""
    FP, n = bT.shape
    B = num_bins_padded
    vals = _rounded_values(g, h, m)
    b = bT.to(torch.int64)
    s = slot_of_row.to(torch.int64)[None, :]
    f = torch.arange(FP, device=bT.device, dtype=torch.int64)[:, None]
    flat = (s * FP + f) * B + b
    ok = (b >= 0) & (b < B) & (s >= 0) & (s < slots)
    flat = torch.where(ok, flat, slots * FP * B)
    out = torch.zeros((slots * FP * B + 1, 3), dtype=torch.float32,
                      device=bT.device)
    out.index_add_(0, flat.reshape(-1), vals.expand(FP, n, 3).reshape(-1, 3))
    return out[:-1].reshape(slots, FP, B, 3)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(bT, g, h, m, num_bins_padded: int):
    if bT.dim() != 2:
        raise ValueError(f"bT must be (FP, n), got shape {tuple(bT.shape)}")
    FP, n = bT.shape
    dev = bT.device
    if bT.dtype != torch.int32:
        raise TypeError(f"bT must be int32, got {bT.dtype}")
    for name, t in (("g", g), ("h", h), ("m", m)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, bT on {dev}")
    if FP % FEATURE_BLOCK or num_bins_padded != pad_bins(num_bins_padded):
        raise ValueError(f"FP={FP} must be a multiple of {FEATURE_BLOCK} and "
                         f"B={num_bins_padded} a pad_bins() size")
    if dev.type == "cuda":
        for name, t in (("bT", bT), ("g", g), ("h", h), ("m", m)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def child_histogram(bT, g, h, m, num_bins_padded: int) -> torch.Tensor:
    """(FP, n) i32 bins + per-row grad/hess/mask → (FP, B, 3) f32 histogram
    of [sum_grad, sum_hess, sum_mask]. Rows with m == 0 contribute nothing
    provided g and h are zeroed too (callers mask all three)."""
    _check(bT, g, h, m, num_bins_padded)
    if bT.device.type == "cpu":
        return _hist_plain(bT, g, h, m, num_bins_padded)
    FP, n = bT.shape
    out = torch.zeros((FP, num_bins_padded, 3), dtype=torch.float32,
                      device=bT.device)
    if bT.numel() == 0:                     # nothing to launch
        return out
    with torch.cuda.device(bT.device):      # the kernel runs on the current device
        rc = _lib().child_histogram(
            bT.data_ptr(), g.data_ptr(), h.data_ptr(), m.data_ptr(),
            out.data_ptr(), n, FP, num_bins_padded,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "child_histogram")
    LAUNCHES["child_histogram"] += 1
    return out


def range_histogram(bT, g, h, m, start, length,
                    num_bins_padded: int) -> torch.Tensor:
    """Histogram of rows [start, start+length) of the FULL (FP, n) arrays —
    no slice copy and no mask multiply. On the card ``start``/``length``
    should be 0-d int tensors on the same device (the kernel reads them
    there, so launching needs no host sync); Python ints are accepted and
    copied to the device."""
    _check(bT, g, h, m, num_bins_padded)
    if bT.device.type == "cpu":
        return _range_hist_plain(bT, g, h, m, start, length, num_bins_padded)
    FP, n = bT.shape
    if isinstance(start, torch.Tensor) and isinstance(length, torch.Tensor):
        info = torch.stack([start.reshape(()), length.reshape(())])
        if info.device != bT.device:
            raise ValueError(f"start/length are on {info.device}, bT on "
                             f"{bT.device}")
        info = info.to(torch.int32).contiguous()
    else:
        info = torch.tensor([int(start), int(length)], dtype=torch.int32,
                            device=bT.device)
    out = torch.zeros((FP, num_bins_padded, 3), dtype=torch.float32,
                      device=bT.device)
    if bT.numel() == 0:
        return out
    with torch.cuda.device(bT.device):
        rc = _lib().range_histogram(
            bT.data_ptr(), g.data_ptr(), h.data_ptr(), m.data_ptr(),
            info.data_ptr(), out.data_ptr(), n, FP, num_bins_padded,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "range_histogram")
    LAUNCHES["range_histogram"] += 1
    return out


def level_histograms(bT, g, h, m, start_chunks, slot_of_row,
                     num_bins_padded: int, slots: int) -> torch.Tensor:
    """(slots, FP, B, 3) histograms of slot-partitioned rows in one pass.

    Rows are grouped by slot in chunks of ``CHUNK`` rows: slot ``s`` owns the
    chunks from ``start_chunks[s]`` up to the next slot's start (the slot of
    chunk ``c`` is the count of ``start_chunks[1:] <= c``; the table is
    non-decreasing, and a slot whose start is the total chunk count owns
    none). Padding rows must carry g = h = m = 0. The kernel reads the slot
    table on the device; the plain version (CPU tensors) takes each row's
    slot from ``slot_of_row`` (n,) instead, which the caller keeps
    consistent with the table. Every slot of the result is defined: a slot
    that owns no row is zero. The kernel sums up to 2048 bins in one pass
    (its bin codes) and a larger B in 2048-bin windows, and takes ``CHUNK``
    a multiple of its 256-row stages."""
    _check(bT, g, h, m, num_bins_padded)
    FP, n = bT.shape
    if tuple(slot_of_row.shape) != (n,) or slot_of_row.device != bT.device:
        raise ValueError(f"slot_of_row must be ({n},) on {bT.device}, got "
                         f"{tuple(slot_of_row.shape)} on {slot_of_row.device}")
    if bT.device.type == "cpu":
        return _level_hist_plain(bT, g, h, m, slot_of_row, num_bins_padded,
                                 slots)
    if (tuple(start_chunks.shape) != (slots,)
            or start_chunks.device != bT.device):
        raise ValueError(f"start_chunks must be ({slots},) on {bT.device}, "
                         f"got {tuple(start_chunks.shape)} on "
                         f"{start_chunks.device}")
    starts = start_chunks.to(torch.int32).contiguous()
    out = torch.zeros((slots, FP, num_bins_padded, 3), dtype=torch.float32,
                      device=bT.device)
    if bT.numel() == 0:
        return out
    with torch.cuda.device(bT.device):
        rc = _lib().level_histogram(
            bT.data_ptr(), g.data_ptr(), h.data_ptr(), m.data_ptr(),
            starts.data_ptr(), out.data_ptr(), n, FP, num_bins_padded, slots,
            CHUNK, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "level_histograms")
    LAUNCHES["level_histograms"] += 1
    return out
