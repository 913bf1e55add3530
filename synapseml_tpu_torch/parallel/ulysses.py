"""Ulysses (DeepSpeed-style) sequence parallelism — all-to-all head scatter.

Counterpart of the JAX package's ``parallel/ulysses.py``. Where the ring
keeps heads whole and rotates K/V, Ulysses re-shards between the two
layouts with one all-to-all each way:

    sequence-sharded [B, S/p, H,  D]
      → head-sharded [B, S,   H/p, D]   (full sequence per rank: exact
                                         attention, no online softmax)
      → back to sequence-sharded.
"""

from __future__ import annotations

from typing import Optional

from .collectives import all_to_all
from .mesh import SEQ_AXIS


def ulysses_self_attention(q, k, v, mesh, causal: bool = False, scale=None,
                           kv_len: Optional[int] = None):
    """Self-attention over the sequence sharded on ``mesh``'s ``seq`` axis:
    q, k and v are THIS rank's shard ``[B_local, S / p, H, D]`` and the
    result is this rank's shard of the attention output. The head count H
    must divide by the seq-axis size p.

    The full-sequence attention of this rank's heads is one launch of the
    CUDA ``flash_attention`` kernel for tensors on the card, its plain
    version for CPU tensors. ``kv_len`` drops keys at positions >= kv_len
    (the padded tail of a non-divisible sequence): the attention takes only
    the first kv_len keys.
    """
    from ..ops.attention_kernel import flash_attention

    if scale is None:
        scale = q.shape[-1] ** -0.5
    sp = mesh.shape[SEQ_AXIS]
    if q.shape[2] % sp:
        raise ValueError(f"heads ({q.shape[2]}) must divide by the seq-axis "
                         f"size ({sp}) for Ulysses attention")
    group = mesh.group(SEQ_AXIS)
    # scatter heads, gather sequence: [B, S/p, H, D] -> [B, S, H/p, D]
    qh, kh, vh = (all_to_all(x, group, split_axis=2, concat_axis=1)
                  for x in (q, k, v))
    if kv_len is not None:
        kh, vh = kh[:, :kv_len], vh[:, :kv_len]
    out = flash_attention(qh, kh, vh, causal=causal, scale=scale)
    # inverse: [B, S, H/p, D] -> [B, S/p, H, D]
    return all_to_all(out, group, split_axis=1, concat_axis=2)
