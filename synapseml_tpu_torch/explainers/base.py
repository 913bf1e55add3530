"""LocalExplainer base machinery (the port's copy of the JAX package's
``explainers/base.py``, with the port's ``device`` param).

Reference: core/.../explainers/LocalExplainer.scala:12-32 (factory),
SharedParams.scala (model/targetCol/targetClasses params), KernelSHAPBase.scala
/ LIMEBase.scala transform scaffolding: per row, generate S perturbed samples,
score them through the wrapped model, fit a weighted local surrogate, output
the coefficients. The host draws are the JAX package's (the same
``np.random.default_rng(0)`` calls in the same order), so both packages
score the same samples; the surrogate fits run on the explainer's
``device``, the wrapped model scores on its own."""

from __future__ import annotations


import numpy as np

from ..core.device import DEFAULT_DEVICE
from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.table import Table


class LocalExplainerBase(Transformer):
    model = Param("model", "The model/pipeline Transformer to explain", object)
    targetCol = Param("targetCol", "Model output column to explain "
                      "(probability/prediction/...)", str, "probability")
    targetClasses = Param("targetClasses", "Class indices to explain (classification)",
                          list, [0])
    targetClassesCol = Param("targetClassesCol", "Per-row class indices column", str)
    outputCol = Param("outputCol", "Output column of explanation weights", str, "explanation")
    metricsCol = Param("metricsCol", "Surrogate-fit metric column (r2)", str, "r2")
    numSamples = Param("numSamples", "Perturbed samples per row", int)
    device = Param("device", "Device of the surrogate fits: 'cuda' "
                   "(default) or 'cpu'", str, DEFAULT_DEVICE)

    def _score(self, samples: Table) -> np.ndarray:
        """Run the wrapped model over perturbed samples → (n, K) targets where
        K = len(targetClasses) for vector targets, else 1."""
        model = self.model
        if model is None:
            raise ValueError("explainer requires the `model` param (a fitted Transformer)")
        scored = model.transform(samples)
        tcol = self.targetCol
        if tcol not in scored:
            raise KeyError(f"targetCol {tcol!r} not in model output "
                           f"(columns: {scored.columns})")
        out = scored[tcol]
        out = np.asarray(out, np.float32) if out.dtype != object else \
            np.stack([np.asarray(o, np.float32) for o in out])
        if out.ndim == 1:
            return out[:, None]
        classes = [int(c) for c in (self.targetClasses or [0])]
        return out[:, classes]

    def _save_extra(self, path: str) -> None:
        import os
        m = self.get("model")
        if m is not None:
            m.save(os.path.join(path, "explained_model"))

    def _load_extra(self, path: str) -> None:
        import os
        from ..core.pipeline import PipelineStage
        p = os.path.join(path, "explained_model")
        if os.path.isdir(p):
            self.set("model", PipelineStage.load(p, self._load_device))


def lime_kernel_weights(distances: np.ndarray, kernel_width: float) -> np.ndarray:
    """exp(-d²/w²) locality kernel (LIMEBase)."""
    return np.exp(-(distances ** 2) / (kernel_width ** 2)).astype(np.float32)


def shap_kernel_lut(num_features: int, inf_weight: float = 1e8) -> np.ndarray:
    """Size-indexed Shapley kernel weights: lut[s] = (M-1)/(C(M,s)·s·(M-s));
    lut[0] = lut[M] = inf_weight (the weights depend only on coalition size)."""
    from math import comb
    m = num_features
    lut = np.full(m + 1, inf_weight, np.float64)
    for s in range(1, m):
        lut[s] = (m - 1) / (comb(m, s) * s * (m - s))
    return lut.astype(np.float32)


def shap_kernel_weights(num_features: int, coalition_sizes: np.ndarray,
                        inf_weight: float = 1e8) -> np.ndarray:
    """Shapley kernel π(z) for a vector of coalition sizes (LUT-indexed)."""
    lut = shap_kernel_lut(num_features, inf_weight)
    return lut[np.asarray(coalition_sizes, np.int64)]


def sample_coalitions_batch(rng: np.random.Generator, num_features: int,
                            num_samples: int, num_rows: int = 1) -> np.ndarray:
    """Coalition tensor (R, S, M) ∈ {0,1}: per row, sample 0 = empty coalition,
    sample 1 = full, the rest uniform-within-size with sizes drawn ~
    Shapley-kernel mass (KernelSHAPSampler). Fully vectorized: size-s masks via
    rank-thresholded random keys."""
    m, s, r = num_features, num_samples, num_rows
    if s < 2:
        raise ValueError(f"numSamples must be >= 2 (empty + full coalition), got {s}")
    out = np.zeros((r, s, m), np.float32)
    out[:, 1] = 1.0
    if s > 2 and m > 1:
        sizes = np.arange(1, m)
        p = (m - 1) / (sizes * (m - sizes))
        p = p / p.sum()
        draw = rng.choice(sizes, size=(r, s - 2), p=p)            # (R, S-2)
        keys = rng.random((r, s - 2, m))
        ranks = np.argsort(np.argsort(keys, axis=-1), axis=-1)    # uniform ranks
        out[:, 2:] = (ranks < draw[:, :, None]).astype(np.float32)
    return out


def sample_coalitions(rng: np.random.Generator, num_features: int,
                      num_samples: int) -> np.ndarray:
    """(S, M) single-row convenience wrapper over sample_coalitions_batch."""
    return sample_coalitions_batch(rng, num_features, num_samples, 1)[0]


def coefs_to_column(coefs: np.ndarray) -> np.ndarray:
    """(R, D, K) solver output → object column of per-row (K, D) matrices."""
    r = coefs.shape[0]
    out = np.empty(r, object)
    for i in range(r):
        out[i] = coefs[i].T
    return out


def default_num_samples(num_features: int, cap: int = 5000) -> int:
    """2M+2048 heuristic (KernelSHAPBase default sample count)."""
    return min(2 * num_features + 2048, cap)
