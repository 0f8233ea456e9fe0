"""CQL: conservative Q-learning on offline data (discrete form), the learner
on the device.

Counterpart of ``ray_tpu/rllib/cql.py`` (after RLlib's CQL: a
conservative penalty on top of the Q backbone).  The discrete form adds
the CQL(H) penalty ``E[logsumexp_a Q(s,a) - Q(s, a_data)]`` to a double-Q
TD loss: actions the data does not take are pushed down against the ones
it does, which keeps pure-offline Q-learning stable.

Offline input is MARWIL's episode format (``marwil.collect_episodes``,
``episodes_from_jsonl``, ``episodes_from_dataset``).  One update is the
double-Q target, the penalised TD loss and the clipped Adam step on a
[batch] of rows indexed on the device.
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Union

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import module as module_mod
from ray_tpu_torch.rllib.dqn import target_copy
from ray_tpu_torch.rllib.marwil import env_action_count, greedy_return
from ray_tpu_torch.train.step import ClippedAdam


@dataclass
class CQLConfig:
    """Reference: rllib/algorithms/cql/cql.py CQLConfig (bc_iters /
    min_q_weight -> cql_alpha here)."""

    env: Union[str, Callable] = "CartPole-v1"
    episodes: List[dict] = None  # offline input (required)
    gamma: float = 0.99
    lr: float = 5e-4
    grad_clip: float = 10.0
    cql_alpha: float = 1.0     # conservative penalty weight
    target_update_freq: int = 200  # updates between target syncs
    train_batch_size: int = 256
    num_updates_per_iter: int = 64
    hidden: tuple = (64, 64)
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "CQL":
        if not self.episodes:
            raise ValueError("CQL is offline: config.episodes required")
        return CQL(self, device)


def _cql_update(params, target_params, opt_state, batch, *, gamma: float,
                lr: float, grad_clip: float, cql_alpha: float):
    """One update on the device of ``batch``: ``params`` and ``opt_state``
    in place; returns (params, opt_state, loss, td_loss, cql_gap)."""
    p = module_mod.trainable(params)
    q, _ = module_mod.forward(p, batch["obs"])                 # [B, A]
    q_data = q.gather(1, batch["actions"][:, None])[:, 0]
    with torch.no_grad():
        # double-Q target from the target net, greedy by the online net
        q_next_online, _ = module_mod.forward(params, batch["next_obs"])
        q_next_target, _ = module_mod.forward(target_params,
                                              batch["next_obs"])
        next_a = torch.argmax(q_next_online, dim=-1)
        q_next = q_next_target.gather(1, next_a[:, None])[:, 0]
        target = (batch["rewards"]
                  + gamma * (1.0 - batch["dones"]) * q_next)
    td = torch.mean((q_data - target) ** 2)
    # CQL(H): push down the soft-maximum over ALL actions, push up the
    # dataset action: the conservative gap
    gap = torch.mean(torch.logsumexp(q, dim=-1) - q_data)
    loss = td + cql_alpha * gap
    ClippedAdam(learning_rate=lr, grad_clip=grad_clip).update(
        params, module_mod.gradients(loss, p), opt_state)
    return params, opt_state, loss.detach(), td.detach(), gap.detach()


class CQL:
    """Tune-compatible trainable over a fixed offline dataset.  The
    learner's tensors and the transitions live on ``device`` (CUDA unless
    ``device="cpu"``); each minibatch's row indices come from the config
    seed's numpy generator, as the JAX learner's do."""

    def __init__(self, config: CQLConfig, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        obs, actions, rewards, next_obs, dones = [], [], [], [], []
        for ep in config.episodes:
            T = len(ep["rewards"])
            obs.append(ep["obs"][:T])
            actions.append(ep["actions"][:T])
            rewards.append(ep["rewards"])
            nxt = np.concatenate([ep["obs"][1:T],
                                  ep["obs"][T - 1:T]], axis=0)
            next_obs.append(nxt)
            d = np.zeros(T, np.float32)
            d[-1] = 1.0  # episode boundary terminates the bootstrap
            dones.append(d)
        cols = {"obs": np.concatenate(obs).astype(np.float32),
                "actions": np.concatenate(actions).astype(np.int64),
                "rewards": np.concatenate(rewards).astype(np.float32),
                "next_obs": np.concatenate(next_obs).astype(np.float32),
                "dones": np.concatenate(dones)}
        self._n = len(cols["obs"])
        self._data = {k: torch.from_numpy(v).to(self.device)
                      for k, v in cols.items()}
        n_actions = env_action_count(config.env,
                                     int(cols["actions"].max()) + 1)
        mcfg = module_mod.MLPConfig(obs_dim=cols["obs"].shape[1],
                                    n_actions=n_actions,
                                    hidden=config.hidden)
        self.params = module_mod.init_mlp(
            mcfg, torch.Generator().manual_seed(config.seed), self.device)
        self.target_params = target_copy(self.params)
        self.opt_state = ClippedAdam().init(self.params)
        self._rng = np.random.default_rng(config.seed)
        self._updates = 0
        self._iter = 0

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        stats = []
        n = self._n
        for _ in range(c.num_updates_per_iter):
            idx = self._rng.integers(0, n, size=min(c.train_batch_size, n))
            rows = torch.from_numpy(idx).to(self.device)
            batch = {k: v[rows] for k, v in self._data.items()}
            (self.params, self.opt_state, loss, td, gap) = _cql_update(
                self.params, self.target_params, self.opt_state, batch,
                gamma=c.gamma, lr=c.lr, grad_clip=c.grad_clip,
                cql_alpha=c.cql_alpha)
            stats.append(torch.stack([loss, td, gap]))
            self._updates += 1
            if self._updates % c.target_update_freq == 0:
                self.target_params = target_copy(self.params)
        loss, td, gap = np.mean(torch.stack(stats).tolist(), axis=0)
        self._iter += 1
        return {
            "training_iteration": self._iter,
            "loss": loss,
            "td_loss": td,
            "cql_gap": gap,
            "num_transitions": n,
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def evaluate(self, n_episodes: int = 5, seed: int = 123) -> float:
        """Greedy rollouts in the real env, on the CPU from a host copy of
        the parameters; the mean episode return."""
        return greedy_return(module_mod.host_copy(self.params),
                             self.config.env, n_episodes, seed)

    # -- checkpointing ------------------------------------------------------
    _STATE = ("params", "target_params", "opt_state")

    def save(self, path: str) -> None:
        state = {k: module_mod.host_copy(getattr(self, k))
                 for k in self._STATE}
        with open(path, "wb") as f:
            pickle.dump({**state, "updates": self._updates,
                         "iter": self._iter}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            st = pickle.load(f)
        for k in self._STATE:
            setattr(self, k, module_mod.tree_to(st[k], self.device))
        self._updates = st["updates"]
        self._iter = st["iter"]

    def stop(self) -> None:
        pass
