"""Flash-attention forward — hand-written CUDA for Hopper, plain PyTorch beside.

Counterpart of the JAX package's ``ops/attention_kernel.py``, with its
layouts: q is ``(B, Sq, H, D)``, k and v ``(B, Sk, H, D)``, float32 or
bfloat16; the softmax state is float32.

* ``flash_attention`` ← ``_flash_kernel`` via ``_flash_forward``: the fused
  online-softmax attention, output in q's type. Ulysses' inner attention.
* ``flash_attention_block`` ← ``_flash_block_kernel``: one update of the
  carried state ``m``, ``l`` ``(B, H, Sq)`` and the unnormalised ``o``
  ``(B, Sq, H, D)`` at global offsets ``q_offset``/``k_offset``. The ring's
  step.

Both run ``csrc/attention_kernel.cu`` for CUDA tensors (one launch each,
counted in ``LAUNCHES``) and their plain versions for CPU tensors:
``_xla_fallback`` (the blockwise path at the largest block that divides Sk,
or the reference einsum) and the ring's ``_block_attention``. The kernels
take any head dim: up to 128 on the tensor cores, wider heads through a
plain CUDA-core kernel of the same function. A CUDA tensor never falls back to the plain version: the kernel launches or the call
raises. Both are ``torch.autograd.Function``s whose backward recomputes
through the plain version with autograd, as the JAX package's custom VJP of
``flash_attention`` does; ``flash_attention_block`` gets the same recompute
backward, so a ring built on the kernel stays differentiable.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..parallel.ring_attention import (_block_attention, attention_reference,
                                       blockwise_attention)

_NEG_INF = -1e30          # finite -inf stand-in: keeps exp() NaN-free
# the wide kernel (head dims above 128) keeps its output rows in shared
# memory up to this D and in a float32 scratch buffer beyond it
WIDE_ACC_MAX_D = 2048     # csrc/attention_kernel.cu kWideAccMaxD

# launches of each hand-written kernel (incremented only where it launches)
LAUNCHES = {"flash_attention": 0, "flash_attention_block": 0}

_P = ctypes.c_void_p
_GEOM_LEN = 29            # csrc/attention_kernel.cu kGeomLen
_SIGNATURES = {
    "flash_geom_len": ([], ctypes.c_int),
    "flash_wide_acc_max_d": ([], ctypes.c_int),
    "flash_attention_fwd": ([_P, _P, _P, _P, _P, _P, ctypes.c_float,
                             ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
    "flash_block_fwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
                        ctypes.c_int),
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from . import _build

    lib = _build.load("attention_kernel", _SIGNATURES)
    if (lib.flash_geom_len() != _GEOM_LEN
            or lib.flash_wide_acc_max_d() != WIDE_ACC_MAX_D):
        raise RuntimeError("csrc/attention_kernel.cu and ops/attention_kernel"
                           ".py disagree on the geometry array's length or "
                           "the wide kernel's shared-memory head dim")
    return lib


def divisor_block(s: int, want: int, floor: int = 8) -> int:
    """Largest divisor of ``s`` that is <= ``want`` and >= ``floor`` (0 when
    none exists) — keeps the blockwise path available for non-divisible
    sequence lengths instead of the O(S^2) reference."""
    for b in range(min(want, s), floor - 1, -1):
        if s % b == 0:
            return b
    return 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the backward's recompute; the card's
# reference in chip_smoke.py)
# ---------------------------------------------------------------------------

def _xla_fallback(q, k, v, causal: bool, scale: float, block_k: int):
    """The blockwise path at the largest workable block divisor of Sk, or
    the reference einsum when no divisor >= 8 exists (near-prime lengths):
    one semantic, chosen by shape."""
    bs = divisor_block(k.shape[1], block_k)
    if bs:
        return blockwise_attention(q, k, v, block_size=bs, causal=causal,
                                   scale=scale)
    return attention_reference(q, k, v, causal=causal, scale=scale)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_qkv(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, H, D)")
    B, _, H, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D) \
            or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, Sk, H, D) with q's B, H, D; got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or all bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v are on {q.device}, {k.device}, "
                         f"{v.device}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")


def _check_state(q, m, l, o) -> None:
    B, Sq, H, D = q.shape
    for name, t, shape in (("m", m, (B, H, Sq)), ("l", l, (B, H, Sq)),
                           ("o", o, (B, Sq, H, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _geom(q, k, v, q_offset: int = 0, k_offset: int = 0, m=None, l=None,
          o=None):
    """The kernel's int64 geometry array: B, H, Sq, Sk, D, the offsets, the
    (b, s, h, d) element strides of q, k, v and o, the (b, h, s) strides of
    m and l (zeros where there is no carried state)."""
    B, Sq, H, D = q.shape
    vals = [B, H, Sq, k.shape[1], D, int(q_offset), int(k_offset),
            *q.stride(), *k.stride(), *v.stride(),
            *(o.stride() if o is not None else (0,) * 4),
            *(m.stride() if m is not None else (0,) * 3),
            *(l.stride() if l is not None else (0,) * 3)]
    return (ctypes.c_int64 * _GEOM_LEN)(*vals)


def _wide_scratch(q):
    """The wide kernel's float32 output slabs (16 query rows x D per
    block) where D is above ``WIDE_ACC_MAX_D``; else None (no buffer)."""
    B, Sq, H, D = q.shape
    if D <= WIDE_ACC_MAX_D:
        return None
    return torch.empty(B * H * -(-Sq // 16) * 16 * D, dtype=torch.float32,
                       device=q.device)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _flash_forward(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """One launch of the fused kernel on CUDA tensors."""
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:                    # nothing to launch
        return out
    geom = _geom(q, k, v)
    scratch = _wide_scratch(q)
    with torch.cuda.device(q.device):       # the kernel runs on the current device
        rc = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), geom, scale, int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def _flash_block_forward(q, k, v, m, l, o, q_offset: int, k_offset: int,
                         causal: bool, scale: float):
    """One launch of the state-carrying kernel on CUDA tensors."""
    m2 = torch.empty(m.shape, dtype=torch.float32, device=q.device)
    l2 = torch.empty(l.shape, dtype=torch.float32, device=q.device)
    o2 = torch.empty(o.shape, dtype=torch.float32, device=q.device)
    if o2.numel() == 0:
        return m2, l2, o2
    geom = _geom(q, k, v, q_offset, k_offset, m, l, o)
    scratch = _wide_scratch(q)
    with torch.cuda.device(q.device):
        rc = _lib().flash_block_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
            l.data_ptr(), o.data_ptr(), m2.data_ptr(), l2.data_ptr(),
            o2.data_ptr(), None if scratch is None else scratch.data_ptr(),
            geom, scale, int(causal),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "flash_attention_block")
    LAUNCHES["flash_attention_block"] += 1
    return m2, l2, o2


def _recompute_grads(fn, inputs, grads):
    """Gradients of ``fn(*inputs)`` (a tensor or a tuple of tensors) against
    ``grads``, recomputed with autograd."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in inputs]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(y, g) for y, g in zip(outs, grads) if g is not None]
        return torch.autograd.grad([y for y, _ in pairs],
                                   xs, [g for _, g in pairs],
                                   allow_unused=True)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, scale, block_k)
        if q.device.type == "cpu":
            return _xla_fallback(q, k, v, causal, scale, block_k)
        return _flash_forward(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        causal, scale, block_k = ctx.args
        grads = _recompute_grads(
            lambda a, b, c: _xla_fallback(a, b, c, causal, scale, block_k),
            ctx.saved_tensors, (g,))
        return (*grads, None, None, None)


class _FlashAttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, m, l, o, q_offset, k_offset, causal, scale):
        ctx.save_for_backward(q, k, v, m, l, o)
        ctx.args = (q_offset, k_offset, causal, scale)
        if q.device.type == "cpu":
            return _block_attention(q, k, v, m, l, o, q_offset, k_offset,
                                    causal, scale)
        return _flash_block_forward(q, k, v, m, l, o, q_offset, k_offset,
                                    causal, scale)

    @staticmethod
    def backward(ctx, gm, gl, go):
        q_offset, k_offset, causal, scale = ctx.args
        grads = _recompute_grads(
            lambda *a: _block_attention(*a, q_offset, k_offset, causal,
                                        scale),
            ctx.saved_tensors, (gm, gl, go))
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_k: int = 128) -> torch.Tensor:
    """Fused flash attention, differentiable: ``(B, Sq, H, D)`` queries over
    ``(B, Sk, H, D)`` keys/values, output in q's type. The causal mask is
    absolute-position (row >= column). ``block_k`` is the plain blockwise
    path's block (CPU tensors and the backward's recompute); the kernel
    tiles on its own. ``scale`` defaults to ``D ** -0.5``."""
    _check_qkv(q, k, v)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), scale, int(block_k))


def flash_attention_block(q, k, v, m, l, o, q_offset: int, k_offset: int,
                          causal: bool = False,
                          scale: Optional[float] = None):
    """One fused online-softmax update of carried state — the kernel form of
    ``parallel.ring_attention._block_attention``: q ``(B, Sq, H, D)``, k/v
    ``(B, Sk, H, D)``, running max ``m`` and normaliser ``l`` ``(B, H, Sq)``
    and the unnormalised ``o`` ``(B, Sq, H, D)``, all three float32; the
    offsets are the blocks' global sequence starts. Returns the new
    ``(m, l, o)``. The kernel maps ``-inf`` in ``m`` to ``-1e30`` and returns
    ``-1e30`` for a row no key has reached (the plain version keeps
    ``-inf``); finalise with ``ring_attention._finalize`` either way."""
    _check_qkv(q, k, v)
    _check_state(q, m, l, o)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttentionBlock.apply(q, k, v, m, l, o, int(q_offset),
                                      int(k_offset), bool(causal), scale)
