"""The analytic prior behind ``seq_attention="auto"``.

The port's copy of the part of the JAX package's ``core/perfmodel.py`` that
the text trainer reads: ``suggest_seq_attention``'s wire-byte model of ring
against Ulysses attention. The JAX package lets recorded ``seq_attention``
rows of its measurement journal displace the prior; those rows were taken
on TPUs or CPUs and say nothing of this card, so the port reads none of
them and decides on the prior alone. It reads nothing from the environment
either (the JAX package's ``SYNAPSEML_TPU_SEQ_ATTENTION`` override is not
carried over): an explicit ``"ring"`` or ``"ulysses"`` is how a caller
overrides it.
"""

from __future__ import annotations

from typing import Tuple


def suggest_seq_attention(heads: int, seq_shards: int) -> Tuple[str, dict]:
    """(variant, provenance) for seq-sharded self-attention over ``p =
    seq_shards`` ranks: the variant that moves fewer activation bytes over
    the ``seq`` axis per layer, in units of the layer's activation ``E =
    B·S·H·D``. Ring rotates the local K/V blocks ``p - 1`` times
    (``2·E/p`` a turn), half of it hidden behind the block compute:
    ``(p - 1)/p · E``. Ulysses re-shards with four all-to-alls (q, k, v in,
    the output back), each moving ``(p - 1)/p`` of E: ``4·(p - 1)/p · E``,
    and is a candidate only when the heads divide by p.

    The prior therefore prefers ring for every shape and link rate (the
    sequence length, batch, head dim and link rate scale both costs alike,
    so they are not arguments); the steps measured on an H100 agree (ring
    1.16-1.29 s against Ulysses 1.78-1.87 s a step at the estimator's
    default widths and 8192 tokens on two ranks, ``chip_smoke.py`` phase
    9)."""
    p = max(1, int(seq_shards))
    cost = {"ring": (p - 1) / p}
    if heads % p == 0:
        cost["ulysses"] = 4 * (p - 1) / p
    arm = min(cost, key=cost.get)
    return arm, {"arm": arm, "source": "analytic", "analytic_E": cost,
                 "fallback_used": False}
