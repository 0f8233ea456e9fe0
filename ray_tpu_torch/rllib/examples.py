"""Example environments (reference: RLlib's ``rllib/examples/envs/``).

A copy of ``ray_tpu/rllib/examples.py``: the port imports nothing of
``ray_tpu``.  Importable everywhere, so they pickle by reference."""

from __future__ import annotations

import numpy as np


class _DiscreteSpace:
    def __init__(self, n: int):
        self.n = n


class TargetMatchEnv:
    """Cooperative multi-agent contextual bandit, parallel dict API: every
    step each agent sees a one-hot target and earns 1.0 for choosing its
    index.  Learnable in a handful of PPO updates; random play averages
    1/N_ACTIONS per agent-step.  Used by tests/test_multi_agent.py and as
    the minimal template for custom multi-agent envs."""

    N_ACTIONS = 4
    EP_LEN = 16

    def __init__(self, agents=("a0", "a1"), seed: int = 0):
        self.agents = tuple(agents)
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._target = 0

    def action_space(self, agent_id):
        return _DiscreteSpace(self.N_ACTIONS)

    def _obs(self):
        onehot = np.zeros(self.N_ACTIONS, np.float32)
        onehot[self._target] = 1.0
        return {a: onehot.copy() for a in self.agents}

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._target = int(self._rng.integers(self.N_ACTIONS))
        return self._obs(), {}

    def step(self, actions):
        rews = {a: float(actions[a] == self._target) for a in self.agents}
        self._t += 1
        self._target = int(self._rng.integers(self.N_ACTIONS))
        done = self._t >= self.EP_LEN
        terms = {a: False for a in self.agents}
        terms["__all__"] = done
        truncs = {a: False for a in self.agents}
        truncs["__all__"] = False
        return self._obs(), rews, terms, truncs, {}


class _BoxSpace:
    def __init__(self, shape):
        self.shape = shape


class OneHotBanditEnv:
    """Single-agent contextual bandit with the gymnasium 5-tuple API: the
    observation is a one-hot target; choosing its index earns 1.0.  The
    reward is a deterministic function of (previous obs, action), which a
    one-step world model can learn exactly — the minimal end-to-end check
    for model-based algorithms (DreamerV3 in the JAX package).  Random
    play averages EP_LEN/N_ACTIONS per episode."""

    N_ACTIONS = 4
    EP_LEN = 16

    def __init__(self, seed: int = 0):
        self.observation_space = _BoxSpace((self.N_ACTIONS,))
        self.action_space = _DiscreteSpace(self.N_ACTIONS)
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._target = 0

    def _obs(self):
        onehot = np.zeros(self.N_ACTIONS, np.float32)
        onehot[self._target] = 1.0
        return onehot

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._target = int(self._rng.integers(self.N_ACTIONS))
        return self._obs(), {}

    def step(self, action):
        r = float(int(action) == self._target)
        self._t += 1
        self._target = int(self._rng.integers(self.N_ACTIONS))
        trunc = self._t >= self.EP_LEN
        return self._obs(), r, False, trunc, {}
