"""SAC (discrete): twin soft-Q + entropy-regularized policy on the device.

Counterpart of ``ray_tpu/rllib/sac.py`` (after RLlib's SAC: twin-Q,
policy and temperature losses, a Polyak target) in its discrete-action
form: soft Q over an enumeration of the actions instead of a
reparameterized Gaussian.  One update is the twin-Q targets with the
policy-expectation bootstrap, the policy's loss against the Boltzmann
distribution of the Qs, the temperature's step toward the target entropy,
the Polyak average, and three Adam steps.
"""

from __future__ import annotations

import math
import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Union

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import module as module_mod
from ray_tpu_torch.rllib.dqn import target_copy
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer
from ray_tpu_torch.train.step import ClippedAdam, tree_leaves


@dataclass
class SACConfig:
    """Reference: RLlib's ``SACConfig.training()`` args."""

    env: Union[str, Callable] = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 2
    rollout_fragment_length: int = 32
    buffer_size: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    num_updates_per_iter: int = 16
    gamma: float = 0.99
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    tau: float = 0.01              # polyak target smoothing
    initial_alpha: float = 0.2
    # target entropy as a fraction of max entropy log(A) (reference uses
    # the heuristic 0.98 * (-log(1/A)) for discrete SAC)
    target_entropy_scale: float = 0.7
    grad_clip: float = 10.0
    hidden: tuple = (64, 64)
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "SAC":
        return SAC(self, device)


def _init_q(cfg: module_mod.MLPConfig, generator: torch.Generator,
            device: DeviceLike):
    """Twin Q networks: independent torsos + heads (the twin-Q trick damps
    overestimation)."""
    return {"q1": module_mod.init_mlp(cfg, generator, device),
            "q2": module_mod.init_mlp(cfg, generator, device)}


def _q_forward(qp, obs):
    q1, _ = module_mod.forward(qp["q1"], obs)
    q2, _ = module_mod.forward(qp["q2"], obs)
    return q1, q2


def _step(params, loss, opt_state, lr, grad_clip, p):
    """One Adam step of ``params`` in place from the gradient of ``loss``
    with respect to ``p``, their ``trainable`` views."""
    ClippedAdam(learning_rate=lr, grad_clip=grad_clip).update(
        params, module_mod.gradients(loss, p), opt_state)


def _sac_update(pi_params, q_params, q_target, log_alpha,
                pi_opt, q_opt, a_opt, batch, *,
                gamma: float, tau: float, actor_lr: float, critic_lr: float,
                alpha_lr: float, grad_clip: float, target_entropy: float):
    """One update on the device of ``batch``.  Every parameter and
    optimizer state is updated in place; returns the ten outputs of the
    JAX update: (pi_params, q_params, q_target, log_alpha, pi_opt, q_opt,
    a_opt, q_loss, pi_loss, entropy)."""
    alpha = torch.exp(log_alpha.detach())
    a_idx = batch["actions"][:, None]

    # -- critic: y = r + gamma (1-d) E_{a'~pi}[min Q_t(s',a') - a log pi] --
    with torch.no_grad():
        logits_next, _ = module_mod.forward(pi_params, batch["next_obs"])
        pi_next = torch.softmax(logits_next, dim=-1)
        logp_next = torch.log_softmax(logits_next, dim=-1)
        q1_t, q2_t = _q_forward(q_target, batch["next_obs"])
        v_next = torch.sum(pi_next * (torch.minimum(q1_t, q2_t)
                                      - alpha * logp_next), dim=-1)
        y = batch["rewards"] + gamma * (1.0 - batch["dones"]) * v_next
    qp = module_mod.trainable(q_params)
    q1, q2 = _q_forward(qp, batch["obs"])
    q_loss = (torch.mean((q1.gather(1, a_idx)[:, 0] - y) ** 2)
              + torch.mean((q2.gather(1, a_idx)[:, 0] - y) ** 2))
    _step(q_params, q_loss, q_opt, critic_lr, grad_clip, qp)

    # -- actor: E_{s}[ E_{a~pi}[ alpha log pi(a|s) - min Q(s,a) ] ] --------
    with torch.no_grad():
        q1, q2 = _q_forward(q_params, batch["obs"])
        q_min = torch.minimum(q1, q2)
    pp = module_mod.trainable(pi_params)
    logits, _ = module_mod.forward(pp, batch["obs"])
    pi = torch.softmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    pi_loss = torch.mean(torch.sum(pi * (alpha * logp - q_min), dim=-1))
    entropy = -torch.mean(torch.sum(pi * logp, dim=-1)).detach()
    _step(pi_params, pi_loss, pi_opt, actor_lr, grad_clip, pp)

    # -- temperature: drive entropy toward the target (adam, unclipped) ----
    la = module_mod.trainable(log_alpha)
    _step(log_alpha, torch.exp(la) * (entropy - target_entropy), a_opt,
          alpha_lr, math.inf, la)

    # -- polyak target sync -------------------------------------------------
    with torch.no_grad():
        target = tree_leaves(q_target)
        torch._foreach_mul_(target, 1.0 - tau)
        torch._foreach_add_(target, tree_leaves(q_params), alpha=tau)
    return (pi_params, q_params, q_target, log_alpha, pi_opt, q_opt, a_opt,
            q_loss.detach(), pi_loss.detach(), entropy)


class SAC:
    """Tune-compatible trainable: train() -> result dict.  The learner's
    tensors live on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, config: SACConfig, device: DeviceLike = None):
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
        generator = torch.Generator().manual_seed(config.seed)
        self.pi_params = module_mod.init_mlp(mcfg, generator, self.device)
        self.q_params = _init_q(mcfg, generator, self.device)
        self.q_target = target_copy(self.q_params)
        self.log_alpha = torch.tensor(float(np.log(config.initial_alpha)),
                                      device=self.device)
        self.target_entropy = float(
            config.target_entropy_scale * np.log(spec["n_actions"]))
        self.pi_opt = ClippedAdam().init(self.pi_params)
        self.q_opt = ClippedAdam().init(self.q_params)
        self.a_opt = ClippedAdam().init(self.log_alpha)
        self.buffer = ReplayBuffer(config.buffer_size, seed=config.seed)
        self._env_steps = 0
        self._iter = 0

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        # exploration samples from the softmax policy
        params_ref = ray_tpu_torch.put(module_mod.host_copy(self.pi_params))
        batches = ray_tpu_torch.get([
            r.sample_transitions.remote(params_ref,
                                        c.rollout_fragment_length,
                                        0.0, "softmax")
            for r in self._runners
        ], timeout=600)
        for b in batches:
            self.buffer.add(b)
            self._env_steps += len(b["rewards"])
        t_sampled = time.perf_counter()

        q_losses, pi_losses, entropies = [], [], []
        n_updates = 0
        if len(self.buffer) >= max(c.learning_starts, c.train_batch_size):
            for _ in range(c.num_updates_per_iter):
                s = self.buffer.sample(c.train_batch_size)
                s["actions"] = s["actions"].astype(np.int64)
                batch = {k: torch.from_numpy(s[k]).to(self.device)
                         for k in ("obs", "actions", "rewards", "next_obs",
                                   "dones")}
                (self.pi_params, self.q_params, self.q_target,
                 self.log_alpha, self.pi_opt, self.q_opt, self.a_opt,
                 q_loss, pi_loss, entropy) = _sac_update(
                    self.pi_params, self.q_params, self.q_target,
                    self.log_alpha, self.pi_opt, self.q_opt, self.a_opt,
                    batch, gamma=c.gamma, tau=c.tau, actor_lr=c.actor_lr,
                    critic_lr=c.critic_lr, alpha_lr=c.alpha_lr,
                    grad_clip=c.grad_clip,
                    target_entropy=self.target_entropy)
                q_losses.append(float(q_loss))
                pi_losses.append(float(pi_loss))
                entropies.append(float(entropy))
                n_updates += 1
        learn_ms = (time.perf_counter() - t_sampled) * 1e3

        metrics = ray_tpu_torch.get(
            [r.get_metrics.remote() for r in self._runners], timeout=60)
        returns = [x for m in metrics for x in m["episode_returns"]]
        self._iter += 1
        return {
            "training_iteration": self._iter,
            "env_steps_sampled": self._env_steps,
            "num_updates": n_updates,
            "alpha": float(torch.exp(self.log_alpha)),
            "entropy": float(np.mean(entropies)) if entropies else None,
            "q_loss": float(np.mean(q_losses)) if q_losses else None,
            "pi_loss": float(np.mean(pi_losses)) if pi_losses else None,
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else None),
            "buffer_size": len(self.buffer),
            "time_this_iter_s": time.perf_counter() - t0,
            "sample_time_s": t_sampled - t0,
            "learn_time_ms": learn_ms,
        }

    # -- checkpointing (Tune/Checkpointable parity) ------------------------
    _STATE = ("pi_params", "q_params", "q_target", "log_alpha", "pi_opt",
              "q_opt", "a_opt")

    def save(self, path: str) -> None:
        state = {k: module_mod.host_copy(getattr(self, k))
                 for k in self._STATE}
        with open(path, "wb") as f:
            pickle.dump({**state, "env_steps": self._env_steps,
                         "iter": self._iter}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            st = pickle.load(f)
        for k in self._STATE:
            setattr(self, k, module_mod.tree_to(st[k], self.device))
        self._env_steps, self._iter = st["env_steps"], st["iter"]

    def stop(self) -> None:
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
