"""Hyperparameter space definitions (reference: core/.../automl/
{HyperparamBuilder,ParamSpace,DefaultHyperparams}.scala).

The port's copy of the JAX package's ``automl/hyperparams.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np


class DiscreteHyperParam:
    """A finite set of candidate values."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def sample(self, rng: np.random.Generator):
        return self.values[int(rng.integers(0, len(self.values)))]

    def grid(self) -> List[Any]:
        return list(self.values)


class RangeHyperParam:
    """A continuous [low, high) range (log-scale optional)."""

    def __init__(self, low, high, log: bool = False, integer: bool = None):
        self.low, self.high, self.log = low, high, log
        self.integer = (isinstance(low, int) and isinstance(high, int)
                        if integer is None else integer)

    def sample(self, rng: np.random.Generator):
        if self.log:
            v = float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))
        else:
            v = float(rng.uniform(self.low, self.high))
        return int(round(v)) if self.integer else v

    def grid(self, n: int = 5) -> List[Any]:
        if self.log:
            vals = np.exp(np.linspace(np.log(self.low), np.log(self.high), n))
        else:
            vals = np.linspace(self.low, self.high, n)
        return [int(round(v)) for v in vals] if self.integer else [float(v) for v in vals]


class HyperparamBuilder:
    """Collects (paramName → space) pairs (HyperparamBuilder.scala)."""

    def __init__(self):
        self._space: Dict[str, Any] = {}

    def addHyperparam(self, name: str, space) -> "HyperparamBuilder":
        self._space[name] = space
        return self

    def build(self) -> Dict[str, Any]:
        return dict(self._space)


class GridSpace:
    """Cartesian product of all discrete/gridded spaces (ParamSpace grid)."""

    def __init__(self, space: Dict[str, Any], grid_points: int = 5):
        self.names = list(space)
        self.grids = [space[n].grid() if isinstance(space[n], DiscreteHyperParam)
                      else space[n].grid(grid_points) for n in self.names]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for combo in itertools.product(*self.grids):
            yield dict(zip(self.names, combo))


class RandomSpace:
    """Random draws from each space (ParamSpace random)."""

    def __init__(self, space: Dict[str, Any], num_samples: int, seed: int = 0):
        self.space, self.n, self.seed = space, num_samples, seed

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng(self.seed)
        for _ in range(self.n):
            yield {k: v.sample(rng) for k, v in self.space.items()}
