"""Replay buffers: uniform ring + proportional prioritized.

Counterpart of ``ray_tpu/rllib/replay_buffers.py`` (a copy), itself after
RLlib's ``rllib/utils/replay_buffers/`` (``ReplayBuffer``,
``PrioritizedReplayBuffer`` with its segment tree): storage is
preallocated numpy rings (columnar, so a sampled minibatch goes to the
learner's device as one tensor a column); the prioritized variant keeps
priorities in a flat numpy array and samples by cumulative-sum inversion —
O(n) per draw batch against the reference's O(log n) tree, a fine trade
below ~10M entries.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform FIFO ring over columnar numpy storage."""

    def __init__(self, capacity: int, seed: Optional[int] = None):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        """Add a batch of rows ({col: [B, ...]}); all columns same B."""
        n = len(next(iter(batch.values())))
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = np.asarray(v)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self.capacity, self._size + n)
        self._on_added(idx)

    def _on_added(self, idx: np.ndarray) -> None:
        pass

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        out = {k: v[idx] for k, v in self._cols.items()}
        out["batch_indices"] = idx
        return out


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional PER (Schaul et al. 2016): P(i) ∝ p_i^alpha, importance
    weights w_i = (N * P(i))^-beta / max w."""

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self._prios = np.zeros(self.capacity, np.float64)
        self._max_prio = 1.0

    def _on_added(self, idx: np.ndarray) -> None:
        self._prios[idx] = self._max_prio  # new samples: replay at least once

    def sample(self, batch_size: int,
               beta: Optional[float] = None) -> Dict[str, np.ndarray]:
        beta = self.beta if beta is None else beta
        p = self._prios[: self._size] ** self.alpha
        total = p.sum()
        if total <= 0:
            return super().sample(batch_size)
        probs = p / total
        idx = self._rng.choice(self._size, size=batch_size, p=probs)
        weights = (self._size * probs[idx]) ** (-beta)
        weights = (weights / weights.max()).astype(np.float32)
        out = {k: v[idx] for k, v in self._cols.items()}
        out["batch_indices"] = idx
        out["weights"] = weights
        return out

    def update_priorities(self, indices: np.ndarray,
                          priorities: np.ndarray) -> None:
        prios = np.abs(np.asarray(priorities, np.float64)) + self.eps
        self._prios[np.asarray(indices)] = prios
        self._max_prio = max(self._max_prio, float(prios.max()))
