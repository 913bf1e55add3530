"""Epsilon-greedy contextual-bandit policy over a VW reward model.

The policy side of the continuous-learning loop: a frozen
:class:`~synapseml_tpu_torch.vw.learner.VWState` scores every candidate action's
hashed-feature row, and an epsilon-greedy rule turns scores into a
propensity-logged choice. Each policy instance is IMMUTABLE with respect to
its weights — a promoted snapshot serves exactly the bytes the gate scored,
which is what makes ``ModelRegistry`` version pinning meaningful.

``action_probabilities`` is the off-policy-evaluation surface: the
counterfactual gate asks a CANDIDATE policy for the probability it would
have assigned to the LOGGED action, feeding the SNIPS / Cressie-Read
estimators in ``vw/policyeval``.
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import numpy as np

from ..core.device import DEFAULT_DEVICE
from ..core.table import Table
from ..vw.learner import VWConfig, VWState, vw_predict


def _action_matrix(actions: Sequence, pad_to: int = 1):
    """Stack per-action sparse rows into (K, P) idx/val arrays."""
    rows = [np.asarray(a) for a in actions]
    p = max([pad_to] + [r.shape[-1] for r in rows])
    idx = np.zeros((len(rows), p), np.int32)
    val = np.zeros((len(rows), p), np.float32)
    for i, r in enumerate(rows):
        k = r.shape[-1]
        idx[i, :k] = r["idx"]
        val[i, :k] = r["val"]
    return idx, val


class GreedyPolicy:
    """Epsilon-greedy over predicted rewards; deterministic per seed.

    ``choose`` returns the 1-based action plus the propensity it was drawn
    with (the ``probability`` the feedback log needs); ties break to the
    lowest index so two policies built from identical bytes always agree.
    """

    def __init__(self, state: VWState, cfg: VWConfig, epsilon: float = 0.05,
                 seed: int = 0, version: str = "v0"):
        if not (0.0 <= epsilon <= 1.0):
            raise ValueError(f"epsilon must be in [0, 1], got {epsilon}")
        self.state = state
        self.cfg = cfg
        self.epsilon = epsilon
        self.version = version
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()

    def scores(self, actions: Sequence) -> np.ndarray:
        idx, val = _action_matrix(actions)
        return vw_predict(self.state, idx, val)

    def action_probabilities(self, actions: Sequence) -> np.ndarray:
        """Epsilon-greedy distribution over the K candidate actions —
        the ``p_target`` column of off-policy evaluation."""
        s = self.scores(actions)
        k = len(s)
        probs = np.full(k, self.epsilon / k, np.float64)
        probs[int(np.argmax(s))] += 1.0 - self.epsilon
        return probs

    def choose(self, actions: Sequence) -> Tuple[int, float]:
        """Sample one action; returns (1-based action, propensity)."""
        probs = self.action_probabilities(actions)
        with self._rng_lock:
            a = int(self._rng.choice(len(probs), p=probs))
        return a + 1, float(probs[a])


def make_policy_handler(policy: GreedyPolicy, featurize) -> "callable":
    """Build a ``Table(id, value) -> Table(id, reply)`` serving handler
    around a frozen policy: each request's JSON value goes through
    ``featurize(value) -> [per-action sparse rows]`` and the reply carries
    ``{"action", "probability", "version"}`` — everything the feedback
    producer needs to log the interaction. The handler closes over ONE
    policy version, so ``ModelRegistry`` hot-swap/pinning semantics apply
    unchanged."""

    def handler(df: Table) -> Table:
        replies: List[dict] = []
        for v in df["value"]:
            actions = featurize(v)
            a, p = policy.choose(actions)
            replies.append({"action": a, "probability": p,
                            "version": policy.version})
        out = np.empty(df.num_rows, dtype=object)
        out[:] = replies
        return df.with_column("reply", out)

    handler.policy = policy
    handler.version = policy.version
    return handler


def policy_builder(cfg: VWConfig, featurize, epsilon: float = 0.05,
                   seed: int = 0, device=DEFAULT_DEVICE):
    """``builder(checkpoint) -> handler`` for
    :meth:`~synapseml_tpu_torch.io.serving.ModelRegistry.swap_from_store`: parse
    the checkpoint's VWState artifact (``ValueError`` on garbage — the
    registry maps it to a rolled-back ``SwapError``) and wrap it as a
    frozen epsilon-greedy serving handler scoring on ``device``."""

    def build(ckpt):
        data = ckpt.artifacts.get(VWState.STORE_ARTIFACT)
        if data is None:
            raise ValueError(
                f"checkpoint {ckpt.base} holds no "
                f"{VWState.STORE_ARTIFACT!r} artifact — not a policy "
                "snapshot")
        state = VWState.from_bytes(data, device)
        policy = GreedyPolicy(state, cfg, epsilon=epsilon, seed=seed,
                              version=ckpt.version)
        return make_policy_handler(policy, featurize)

    return build
