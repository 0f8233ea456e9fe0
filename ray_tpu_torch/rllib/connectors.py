"""Connector pipelines: composable observation/reward transforms.

Counterpart of ``ray_tpu/rllib/connectors.py`` (a copy: the port imports
nothing of ``ray_tpu``), itself after RLlib's new-API-stack connectors
(``rllib/connectors/connector_pipeline_v2.py`` and the env_to_module
pipelines): small, stateful, checkpointable transforms that sit between
the environment and the RLModule, composed into an ordered pipeline the
algorithm owns.  Connectors transform numpy batches on the host, inside
the env runners; the module's forward stays pure.

Built-ins cover the common preprocessing trio: observation flattening,
running-mean/std observation normalization, and reward clipping.  Custom
connectors subclass ``Connector``::

    pipe = ConnectorPipeline([FlattenObs(), NormalizeObs()])
    runner = EnvRunner("CartPole-v1", 2, env_to_module=pipe)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    """One transform stage.  ``transform_obs`` maps a [batch, ...] obs
    array; ``transform_rewards`` maps a [batch] reward array.  Stateful
    connectors implement get_state/set_state for checkpointing."""

    def transform_obs(self, obs: np.ndarray,
                      update: bool = True) -> np.ndarray:
        """update=False applies the transform without advancing any
        running statistics (e.g. next-obs re-projection)."""
        return obs

    def transform_rewards(self, rewards: np.ndarray) -> np.ndarray:
        return rewards

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class FlattenObs(Connector):
    """Flatten structured observations to [batch, -1] (reference:
    env_to_module/flatten_observations.py)."""

    def transform_obs(self, obs: np.ndarray,
                      update: bool = True) -> np.ndarray:
        obs = np.asarray(obs)
        return obs.reshape(obs.shape[0], -1)


class NormalizeObs(Connector):
    """Running mean/std observation filter (reference:
    env_to_module/mean_std_filter.py, Welford accumulation)."""

    def __init__(self, epsilon: float = 1e-8, clip: Optional[float] = 10.0):
        self.eps = epsilon
        self.clip = clip
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def transform_obs(self, obs: np.ndarray,
                      update: bool = True) -> np.ndarray:
        obs = np.asarray(obs, np.float64)
        if self._mean is None:
            self._mean = np.zeros(obs.shape[1:], np.float64)
            self._m2 = np.zeros(obs.shape[1:], np.float64)
        if update:
            for row in obs:  # Welford accumulation
                self._count += 1.0
                delta = row - self._mean
                self._mean += delta / self._count
                self._m2 += delta * (row - self._mean)
        var = self._m2 / max(1.0, self._count - 1.0)
        out = (obs - self._mean) / np.sqrt(var + self.eps)
        if self.clip is not None:
            out = np.clip(out, -self.clip, self.clip)
        return out.astype(np.float32)

    def get_state(self) -> Dict[str, Any]:
        return {"count": self._count,
                "mean": None if self._mean is None else self._mean.copy(),
                "m2": None if self._m2 is None else self._m2.copy()}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._count = state["count"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


class ClipRewards(Connector):
    """Clip rewards to [-limit, limit] (reference: Atari-style reward
    clipping in learner connectors)."""

    def __init__(self, limit: float = 1.0):
        self.limit = limit

    def transform_rewards(self, rewards: np.ndarray) -> np.ndarray:
        return np.clip(rewards, -self.limit, self.limit)


class ConnectorPipeline(Connector):
    """Ordered composition (reference: ConnectorPipelineV2 with
    insert_before/insert_after/remove surgery by class name)."""

    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors: List[Connector] = list(connectors or [])

    # -- pipeline surgery ---------------------------------------------------
    def _index_of(self, name: str) -> int:
        for i, c in enumerate(self.connectors):
            if type(c).__name__ == name:
                return i
        raise ValueError(f"no connector {name!r} in pipeline")

    def insert_before(self, name: str, connector: Connector):
        self.connectors.insert(self._index_of(name), connector)

    def insert_after(self, name: str, connector: Connector):
        self.connectors.insert(self._index_of(name) + 1, connector)

    def append(self, connector: Connector):
        self.connectors.append(connector)

    def remove(self, name: str):
        del self.connectors[self._index_of(name)]

    # -- transforms ---------------------------------------------------------
    def transform_obs(self, obs: np.ndarray,
                      update: bool = True) -> np.ndarray:
        for c in self.connectors:
            obs = c.transform_obs(obs, update=update)
        return obs

    def transform_rewards(self, rewards: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            rewards = c.transform_rewards(rewards)
        return rewards

    def get_state(self) -> Dict[str, Any]:
        # keyed by (position, class): two connectors of the same type must
        # not collide or restore would alias their filter state
        return {f"{i}:{type(c).__name__}": c.get_state()
                for i, c in enumerate(self.connectors)}

    def set_state(self, state: Dict[str, Any]) -> None:
        for i, c in enumerate(self.connectors):
            key = f"{i}:{type(c).__name__}"
            if key in state:
                c.set_state(state[key])
