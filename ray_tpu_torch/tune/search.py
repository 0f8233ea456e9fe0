"""Search spaces + basic variant generation.

Counterpart of ``ray_tpu/tune/search.py``; that is, of the reference's
search space API + BasicVariantGenerator
(Ray's python/ray/tune/search/sample.py — uniform/loguniform/
choice/randint/grid_search — and search/basic_variant.py): grid_search
dimensions form the cross product; sampled dimensions draw num_samples
times.  Pluggable Searcher ABC mirrors search/searcher.py so Optuna-style
backends can drop in (suggest/on_trial_complete).
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclass
class QUniform(Domain):
    low: float
    high: float
    q: float

    def sample(self, rng):
        return round(rng.uniform(self.low, self.high) / self.q) * self.q


@dataclass
class RandInt(Domain):
    low: int
    high: int

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclass
class Choice(Domain):
    options: List[Any]

    def sample(self, rng):
        return rng.choice(self.options)


@dataclass
class GridSearch:
    values: List[Any]


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def quniform(low: float, high: float, q: float) -> QUniform:
    return QUniform(low, high, q)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(options: List[Any]) -> Choice:
    return Choice(list(options))


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(list(values))


class Searcher:
    """Pluggable search backend (reference: tune/search/searcher.py).
    suggest() returns a config dict or None when exhausted."""

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Optional[dict],
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self._rng = random.Random(seed)
        grid_keys = [k for k, v in param_space.items()
                     if isinstance(v, GridSearch)]
        grid_values = [param_space[k].values for k in grid_keys]
        self._grid_combos = (list(itertools.product(*grid_values))
                             if grid_keys else [()])
        self._grid_keys = grid_keys
        self._space = param_space
        self._num_samples = num_samples
        self._emitted = 0
        self._total = num_samples * len(self._grid_combos)

    @property
    def total_trials(self) -> int:
        return self._total

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._emitted >= self._total:
            return None
        combo = self._grid_combos[self._emitted % len(self._grid_combos)]
        cfg: Dict[str, Any] = {}
        for k, v in self._space.items():
            if k in self._grid_keys:
                cfg[k] = combo[self._grid_keys.index(k)]
            elif isinstance(v, Domain):
                cfg[k] = v.sample(self._rng)
            elif callable(v) and not isinstance(v, type):
                cfg[k] = v()  # tune.sample_from-style thunk
            else:
                cfg[k] = v
        self._emitted += 1
        return cfg
