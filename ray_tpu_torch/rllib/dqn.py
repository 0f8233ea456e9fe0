"""DQN: env-runner actors + replay buffer + a double-Q learner on the device.

Counterpart of ``ray_tpu/rllib/dqn.py`` (after RLlib's DQN: the TD-error /
Huber loss, target-network sync, prioritized replay): one update is the
double-Q target, the Huber loss under importance weights and the clipped
Adam step on fixed [batch] shapes, and the per-sample TD errors come back
for the priority updates.
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Union

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import module as module_mod
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.replay_buffers import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
)
from ray_tpu_torch.train.step import ClippedAdam, tree_map


@dataclass
class DQNConfig:
    """Reference: RLlib's ``DQNConfig.training()`` args."""

    env: Union[str, Callable] = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 2
    rollout_fragment_length: int = 32
    buffer_size: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    num_updates_per_iter: int = 16
    gamma: float = 0.99
    lr: float = 1e-3
    grad_clip: float = 10.0
    double_q: bool = True
    prioritized_replay: bool = True
    per_alpha: float = 0.6
    per_beta: float = 0.4
    target_network_update_freq: int = 500  # env steps between syncs
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_steps: int = 5_000
    hidden: tuple = (64, 64)
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "DQN":
        return DQN(self, device)


def _dqn_loss(p, target_params, batch, double_q, gamma):
    q, _ = module_mod.forward(p, batch["obs"])                 # [B, A]
    q_sel = q.gather(1, batch["actions"][:, None])[:, 0]
    with torch.no_grad():
        q_next_t, _ = module_mod.forward(target_params, batch["next_obs"])
        if double_q:
            q_next_o, _ = module_mod.forward(p, batch["next_obs"])
            next_a = torch.argmax(q_next_o, dim=-1)
            q_next = q_next_t.gather(1, next_a[:, None])[:, 0]
        else:
            q_next = q_next_t.max(dim=-1).values
        target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * q_next
    td = q_sel - target
    huber = torch.where(td.abs() < 1.0, 0.5 * td * td, td.abs() - 0.5)
    return torch.mean(batch["weights"] * huber), td


def _dqn_update(params, target_params, opt_state, batch, *,
                double_q: bool, grad_clip: float, lr: float, gamma: float):
    """One update on the device of ``batch``: ``params`` and ``opt_state``
    in place; returns them with the loss and the per-sample TD errors."""
    p = module_mod.trainable(params)
    loss, td = _dqn_loss(p, target_params, batch, double_q, gamma)
    ClippedAdam(learning_rate=lr, grad_clip=grad_clip).update(
        params, module_mod.gradients(loss, p), opt_state)
    return params, opt_state, loss.detach(), td.detach()


def target_copy(params):
    """The target network: a copy on the learner's device that shares no
    storage with ``params``, which the learner updates in place."""
    return tree_map(lambda t: t.detach().clone(), params)


class DQN:
    """Tune-compatible trainable: train() -> result dict.  The learner's
    tensors live on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, config: DQNConfig, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        runner_cls = ray_tpu_torch.remote(EnvRunner)
        self._runners = [
            runner_cls.remote(config.env, config.num_envs_per_runner,
                              seed=config.seed + 1000 * i)
            for i in range(config.num_env_runners)
        ]
        spec = ray_tpu_torch.get(self._runners[0].env_spec.remote(), timeout=60)
        mcfg = module_mod.MLPConfig(
            obs_dim=spec["obs_dim"], n_actions=spec["n_actions"],
            hidden=config.hidden)
        self.params = module_mod.init_mlp(
            mcfg, torch.Generator().manual_seed(config.seed), self.device)
        self.target_params = target_copy(self.params)
        self.opt_state = ClippedAdam().init(self.params)
        if config.prioritized_replay:
            self.buffer: ReplayBuffer = PrioritizedReplayBuffer(
                config.buffer_size, alpha=config.per_alpha,
                beta=config.per_beta, seed=config.seed)
        else:
            self.buffer = ReplayBuffer(config.buffer_size, seed=config.seed)
        self._env_steps = 0
        self._last_target_sync = 0
        self._iter = 0

    # -- epsilon schedule --------------------------------------------------
    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._env_steps / max(1, c.epsilon_decay_steps))
        return c.epsilon_initial + frac * (c.epsilon_final
                                           - c.epsilon_initial)

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        eps = self._epsilon()
        params_ref = ray_tpu_torch.put(module_mod.host_copy(self.params))
        batches = ray_tpu_torch.get([
            r.sample_transitions.remote(params_ref,
                                        c.rollout_fragment_length, eps)
            for r in self._runners
        ], timeout=600)
        for b in batches:
            self.buffer.add(b)
            self._env_steps += len(b["rewards"])
        t_sampled = time.perf_counter()

        losses = []
        n_updates = 0
        if len(self.buffer) >= max(c.learning_starts, c.train_batch_size):
            for _ in range(c.num_updates_per_iter):
                sample = self.buffer.sample(c.train_batch_size)
                cols = {
                    "obs": sample["obs"],
                    "actions": sample["actions"].astype(np.int64),
                    "rewards": sample["rewards"],
                    "next_obs": sample["next_obs"],
                    "dones": sample["dones"],
                    "weights": sample.get(
                        "weights", np.ones(c.train_batch_size, np.float32)),
                }
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in cols.items()}
                self.params, self.opt_state, loss, td = _dqn_update(
                    self.params, self.target_params, self.opt_state, batch,
                    double_q=c.double_q, grad_clip=c.grad_clip, lr=c.lr,
                    gamma=c.gamma)
                losses.append(float(loss))
                n_updates += 1
                if isinstance(self.buffer, PrioritizedReplayBuffer):
                    self.buffer.update_priorities(
                        sample["batch_indices"], td.cpu().numpy())
        if (self._env_steps - self._last_target_sync
                >= c.target_network_update_freq):
            self.target_params = target_copy(self.params)
            self._last_target_sync = self._env_steps
        learn_ms = (time.perf_counter() - t_sampled) * 1e3

        metrics = ray_tpu_torch.get(
            [r.get_metrics.remote() for r in self._runners], timeout=60)
        returns = [x for m in metrics for x in m["episode_returns"]]
        self._iter += 1
        return {
            "training_iteration": self._iter,
            "env_steps_sampled": self._env_steps,
            "num_updates": n_updates,
            "epsilon": eps,
            "loss": float(np.mean(losses)) if losses else None,
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else None),
            "buffer_size": len(self.buffer),
            "time_this_iter_s": time.perf_counter() - t0,
            "sample_time_s": t_sampled - t0,
            "learn_time_ms": learn_ms,
        }

    # -- checkpointing (Tune/Checkpointable parity) ------------------------
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({
                "params": module_mod.host_copy(self.params),
                "target_params": module_mod.host_copy(self.target_params),
                "opt_state": module_mod.host_copy(self.opt_state),
                "env_steps": self._env_steps, "iter": self._iter}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.params = module_mod.tree_to(state["params"], self.device)
        self.target_params = module_mod.tree_to(state["target_params"],
                                                self.device)
        self.opt_state = module_mod.tree_to(state["opt_state"], self.device)
        self._env_steps = state["env_steps"]
        self._iter = state["iter"]

    def stop(self) -> None:
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
