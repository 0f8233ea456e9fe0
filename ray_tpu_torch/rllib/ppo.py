"""PPO: env-runner actors + a learner on the device.

Counterpart of ``ray_tpu/rllib/ppo.py`` (after RLlib's PPO on the new API
stack): ``train()`` samples on the runner actors in parallel, computes GAE
on the host, then runs the clipped-surrogate epochs over minibatches on
the learner's device, and returns a result dict.  JAX compiles the epochs
as two nested ``lax.scan``s; here they are a loop over epochs and
minibatches, each minibatch one autograd pass and one optimizer update.
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import _actors
from ray_tpu_torch.rllib import module as module_mod
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.train.step import ClippedAdam


@dataclass
class PPOConfig:
    """Reference: RLlib's ``PPOConfig`` (training() args)."""

    env: Union[str, Callable] = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    # env-to-module connector pipeline factory (connectors.py): each
    # env-runner actor builds its own pipeline instance (stateful filters
    # like NormalizeObs are per-runner, as in the reference)
    env_to_module: "Optional[Callable]" = None
    rollout_fragment_length: int = 128
    gamma: float = 0.99
    lambda_: float = 0.95
    lr: float = 3e-4
    clip_param: float = 0.2
    num_epochs: int = 4
    minibatch_size: int = 256
    entropy_coeff: float = 0.01
    vf_loss_coeff: float = 0.5
    grad_clip: float = 0.5
    hidden: tuple = (64, 64)
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "PPO":
        return PPO(self, device)

    # fluent-style helpers mirroring RLlib's config methods
    def environment(self, env) -> "PPOConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int = 2,
                    num_envs_per_env_runner: int = 4,
                    rollout_fragment_length: int = 128) -> "PPOConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "PPOConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown PPO option {k!r}")
            setattr(self, k, v)
        return self


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """[T, n] arrays -> (advantages, returns), numpy."""
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    last_adv = np.zeros(rewards.shape[1], rewards.dtype)
    next_value = last_value
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t].astype(rewards.dtype)
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_adv = delta + gamma * lam * nonterminal * last_adv
        adv[t] = last_adv
        next_value = values[t]
    return adv, adv + values


def _ppo_loss(p, mb, clip, ent_coeff, vf_coeff):
    logits, value = module_mod.forward(p, mb["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, mb["actions"][:, None])[:, 0]
    ratio = torch.exp(logp - mb["logp_old"])
    adv = mb["adv"]
    pg = -torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
    vf = torch.square(value - mb["returns"]).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = pg + vf_coeff * vf - ent_coeff * entropy
    return total, (pg, vf, entropy)


def ppo_update(params, opt_state, batch, generator: torch.Generator, *,
               num_epochs: int, minibatch_size: int, clip: float,
               ent_coeff: float, vf_coeff: float, grad_clip: float,
               lr: float):
    """All epochs and minibatches on the device of ``batch``.  Each epoch
    takes a permutation of the N rows from ``generator`` (a CPU
    generator, so the same seed gives the same minibatches on every
    device) and uses its first ``n_mb * minibatch_size`` rows once each,
    ``n_mb = max(1, N // minibatch_size)``; the tail is dropped, as JAX
    drops it.  ``params`` and ``opt_state`` are updated in place and
    returned with the stats: each loss averaged over every minibatch of
    every epoch, as 0-d tensors on the device."""
    opt = ClippedAdam(learning_rate=lr, grad_clip=grad_clip)
    N = batch["obs"].shape[0]
    n_mb = max(1, N // minibatch_size)
    perms = torch.stack([torch.randperm(N, generator=generator)
                         for _ in range(num_epochs)])
    idxs = perms[:, :n_mb * minibatch_size].reshape(
        num_epochs, n_mb, -1).to(batch["obs"].device)
    losses = []
    for epoch in range(num_epochs):
        for m in range(n_mb):
            mb = {k: v[idxs[epoch, m]] for k, v in batch.items()}
            p = module_mod.trainable(params)
            total, aux = _ppo_loss(p, mb, clip, ent_coeff, vf_coeff)
            opt.update(params, module_mod.gradients(total, p), opt_state)
            losses.append(torch.stack([total.detach(), *aux]).detach())
    means = torch.stack(losses).mean(0)
    stats = dict(zip(("total_loss", "policy_loss", "vf_loss", "entropy"),
                     means))
    return params, opt_state, stats


def frags_to_batch(frags, behavior_params, cfg,
                   device: DeviceLike = None) -> dict:
    """Runner fragments -> one flat PPO batch on ``device``: bootstrap
    time-limit truncations with V(s') (runner reports trunc_values; dones
    still cuts the GAE trace there), GAE per fragment on the host from the
    (CPU) params the fragments were sampled with, flatten, normalize
    advantages.  Shared by PPO (fresh params), APPO (one-iteration-stale
    behavior params) and multi-agent PPO (fragments without
    trunc_values)."""
    dev = resolve_device(device)
    obs, acts, logp, adv, rets = [], [], [], [], []
    for f in frags:
        last_value = module_mod.host_values(behavior_params, f["last_obs"])
        rewards = f["rewards"] + cfg.gamma * f.get(
            "trunc_values", np.zeros_like(f["rewards"]))
        a, r = compute_gae(rewards, f["values"], f["dones"],
                           last_value, cfg.gamma, cfg.lambda_)
        T, n = f["rewards"].shape
        obs.append(f["obs"].reshape(T * n, -1))
        acts.append(f["actions"].reshape(-1))
        logp.append(f["logp"].reshape(-1))
        adv.append(a.reshape(-1))
        rets.append(r.reshape(-1))
    adv_all = np.concatenate(adv)
    adv_all = (adv_all - adv_all.mean()) / (adv_all.std() + 1e-8)
    cols = {"obs": np.concatenate(obs).astype(np.float32),
            "actions": np.concatenate(acts).astype(np.int64),
            "logp_old": np.concatenate(logp), "adv": adv_all,
            "returns": np.concatenate(rets)}
    return {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}


class PPO:
    """Reference: RLlib's ``Algorithm`` minimum — train/save/restore/stop
    + evaluate.  The learner's tensors live on ``device`` (CUDA unless
    ``device="cpu"``; raises where CUDA is missing)."""

    def __init__(self, config: PPOConfig, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        runner_cls = _actors.remote(EnvRunner)
        self.runners = [
            runner_cls.remote(
                config.env, config.num_envs_per_runner,
                seed=config.seed + 1000 * i,
                env_to_module=(config.env_to_module()
                               if config.env_to_module else None))
            for i in range(config.num_env_runners)]
        spec = _actors.get(self.runners[0].env_spec.remote(), timeout=60)
        self.module_cfg = module_mod.MLPConfig(
            obs_dim=spec["obs_dim"], n_actions=spec["n_actions"],
            hidden=config.hidden)
        self.params = module_mod.init_mlp(
            self.module_cfg, torch.Generator().manual_seed(config.seed),
            self.device)
        self.opt_state = ClippedAdam().init(self.params)
        self.iteration = 0
        self._timesteps = 0

    def _collect(self):
        """Gather one round of fragments.  Returns (frags,
        behavior_params) — the CPU params the rollouts were sampled with.
        PPO samples synchronously (behavior == current); APPO overrides
        with pipelined one-iteration-stale sampling."""
        cfg = self.config
        behavior = module_mod.host_copy(self.params)
        params_ref = _actors.put(behavior)
        frags = _actors.get(
            [r.sample.remote(params_ref, cfg.rollout_fragment_length)
             for r in self.runners], timeout=600)
        return frags, behavior

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        frags, behavior_params = self._collect()
        t_sampled = time.perf_counter()
        batch = frags_to_batch(frags, behavior_params, cfg, self.device)
        n = batch["obs"].shape[0]
        self._timesteps += n
        t_learn = time.perf_counter()
        self.params, self.opt_state, stats = ppo_update(
            self.params, self.opt_state, batch,
            torch.Generator().manual_seed(self.iteration),
            num_epochs=cfg.num_epochs,
            minibatch_size=min(cfg.minibatch_size, n),
            clip=cfg.clip_param, ent_coeff=cfg.entropy_coeff,
            vf_coeff=cfg.vf_loss_coeff, grad_clip=cfg.grad_clip,
            lr=cfg.lr)
        stats = {k: float(v) for k, v in stats.items()}  # waits for it
        learn_ms = (time.perf_counter() - t_learn) * 1e3
        self.iteration += 1
        metrics = _actors.get([r.get_metrics.remote() for r in self.runners],
                              timeout=60)
        returns = [x for m in metrics for x in m["episode_returns"]]
        lens = [x for m in metrics for x in m["episode_lens"]]
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps,
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else float("nan")),
            "episode_len_mean": (float(np.mean(lens))
                                 if lens else float("nan")),
            "num_episodes": len(returns),
            "time_this_iter_s": time.perf_counter() - t0,
            "sample_time_s": t_sampled - t0,
            "learn_time_ms": learn_ms,
            **stats,
        }

    def evaluate(self, num_episodes: int = 5) -> Dict[str, float]:
        """Greedy policy evaluation on a fresh local env, from a CPU copy
        of the parameters."""
        env = self.config.env
        if isinstance(env, str):
            import gymnasium as gym

            env = gym.make(env)
        else:
            env = env()
        params = module_mod.host_copy(self.params)
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=10_000 + ep)
            done, total = False, 0.0
            while not done:
                a = int(module_mod.greedy_action(params, torch.from_numpy(
                    np.asarray(obs, np.float32)[None]))[0])
                obs, r, term, trunc, _ = env.step(a)
                total += float(r)
                done = term or trunc
            returns.append(total)
        return {"episode_return_mean": float(np.mean(returns))}

    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            pickle.dump({"params": module_mod.host_copy(self.params),
                         "opt_state": module_mod.host_copy(self.opt_state),
                         "iteration": self.iteration,
                         "timesteps": self._timesteps,
                         "config": self.config}, f)
        return path

    @classmethod
    def restore(cls, path: str, device: DeviceLike = None) -> "PPO":
        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        algo = cls(state["config"], device)
        algo.params = module_mod.tree_to(state["params"], algo.device)
        algo.opt_state = module_mod.tree_to(state["opt_state"], algo.device)
        algo.iteration = state["iteration"]
        algo._timesteps = state["timesteps"]
        return algo

    def stop(self):
        for r in self.runners:
            _actors.kill(r)
