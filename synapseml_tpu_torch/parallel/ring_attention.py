"""Ring attention — sequence parallelism over the ``seq`` mesh axis.

Counterpart of the JAX package's ``parallel/ring_attention.py``. Each rank
of a ``seq`` group holds one contiguous shard of the sequence; its queries
stay put while the K/V shards rotate around the ring (``ppermute_next``),
and each rank folds every K/V shard into its queries' online softmax
(running max ``m``, normaliser ``l``, unnormalised output ``o``, all
float32). Causal masking uses global positions derived from each shard's
ring offset, so shard boundaries are invisible to the math.

Layouts are the JAX package's: ``[batch, seq, heads, head_dim]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .collectives import ppermute_next
from .mesh import SEQ_AXIS

_INF = float("inf")


def _block_attention(q, k, v, m, l, o, q_offset, k_offset, causal, scale):
    """One blockwise online-softmax update.

    q: [B, Sq, H, D]; k/v: [B, Sk, H, D]; m, l: [B, H, Sq]; o: [B, Sq, H, D].
    Offsets are the blocks' global sequence starts (for causal masking).
    Scores and the state are float32 whatever q's type; ``p`` is rounded to
    v's type before the PV product, as the kernels do for bfloat16 inputs
    (a no-op for float32).
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, -_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))               # [B, H, Sq]
    # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> use 0
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(torch.where(torch.isfinite(s), s - safe_m[..., None],
                              -_INF))
    p = torch.where(torch.isnan(p), 0.0, p)
    correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    l_new = l * correction + p.sum(dim=-1)
    o_new = (o * correction.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                            v.float()))
    return m_new, l_new, o_new


def _empty_state(q):
    """The online softmax's start: m = -inf, l = 0, o = 0, float32."""
    B, Sq, H, _ = q.shape
    m = torch.full((B, H, Sq), -_INF, dtype=torch.float32, device=q.device)
    return m, torch.zeros_like(m), torch.zeros(q.shape, dtype=torch.float32,
                                               device=q.device)


def _finalize(m, l, o):
    denom = torch.where(l > 0, l, 1.0).transpose(1, 2)[..., None]
    return o / denom


def attention_reference(q, k, v, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain one-device attention (the correctness oracle for the ring): one
    online-softmax update over all keys from the empty state, finalised;
    the output in q's type."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    m, l, o = _block_attention(q, k, v, *_empty_state(q), 0, 0, causal,
                               scale)
    return _finalize(m, l, o).to(q.dtype)


def ring_self_attention(q, k, v, mesh, causal: bool = False,
                        scale: Optional[float] = None,
                        axis: str = SEQ_AXIS,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Exact self-attention over the sequence sharded on ``mesh``'s
    ``axis``: q, k and v are THIS rank's shard ``[B_local, S / R, H, D]``
    (shard i holds positions ``[i * S / R, (i + 1) * S / R)``) and the result
    is this rank's shard of attention over the whole sequence, equal to
    :func:`attention_reference` on the gathered sequence up to float32
    rounding (online softmax is associative). The ring runs inside this
    rank's ``axis`` group only, so with a ``data`` axis beside it each data
    rank passes its own batch rows (the batch rides the data axis).

    Each ring step is one launch of the CUDA ``flash_attention_block``
    kernel for tensors on the card, the plain ``_block_attention`` for CPU
    tensors. ``kv_len`` drops keys at global positions >= kv_len (the
    padded tail of a non-divisible sequence): each step takes only the
    valid prefix of the block it holds, and skips a block with none. The
    accumulators stay float32 whatever q's type; q, k and v enter the kernel
    in their own type (bfloat16 takes its bfloat16 instantiation; the JAX
    package casts them to float32 first) and the output comes back in q's
    type. Differentiable: the collectives and the kernel's recompute
    backward carry the gradient.
    """
    from ..ops.attention_kernel import flash_attention_block

    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ring = mesh.shape[axis]
    rank = mesh.axis_index(axis)
    group = mesh.group(axis)
    s_local = q.shape[1]
    q_offset = rank * s_local
    m, l, o = _empty_state(q)
    k_cur, v_cur = k, v
    for t in range(ring):
        # the block held now arrived from rank (rank - t) mod ring
        k_offset = ((rank - t) % ring) * s_local
        n = s_local if kv_len is None else min(s_local, kv_len - k_offset)
        if n > 0:
            m, l, o = flash_attention_block(
                q, k_cur[:, :n], v_cur[:, :n], m, l, o, q_offset, k_offset,
                causal=causal, scale=scale)
        if t + 1 < ring:            # the last block needs no further turn
            k_cur = ppermute_next(k_cur, group)
            v_cur = ppermute_next(v_cur, group)
    return _finalize(m, l, o).to(q.dtype)


def blockwise_attention(q, k, v, block_size: int, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """One-device blockwise attention (the memory-efficient form the ring
    wraps): K/V consumed in ``block_size`` chunks with the same online
    softmax — O(S·block) memory instead of O(S²)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    n_k = k.shape[1]
    if n_k % block_size:
        raise ValueError(f"sequence {n_k} not divisible by block {block_size}")
    m, l, o = _empty_state(q)
    for t in range(n_k // block_size):
        blk = slice(t * block_size, (t + 1) * block_size)
        m, l, o = _block_attention(q, k[:, blk], v[:, blk], m, l, o, 0,
                                   t * block_size, causal, scale)
    return _finalize(m, l, o).to(q.dtype)
