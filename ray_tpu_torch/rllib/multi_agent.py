"""Multi-agent RL: env protocol, sampling runner, and independent PPO.

Counterpart of ``ray_tpu/rllib/multi_agent.py`` (after RLlib's
``MultiAgentEnv``, ``MultiAgentRLModule`` and ``policy_mapping_fn``):
several agents step one environment; a ``policy_mapping_fn`` routes each
agent id to a policy id; each policy owns its own module and optimizer and
learns from the experience of every agent mapped to it (parameter sharing
falls out of mapping many agents to one policy id).

The environment protocol is the parallel dict API (gymnasium/PettingZoo
shape)::

    obs_dict, infos = env.reset(seed=...)
    obs, rews, terms, truncs, infos = env.step({agent_id: action, ...})
    # terms["__all__"] / truncs["__all__"] end the episode for everyone

Each policy's update is the single-agent ``ppo_update``, and its batch
stacks agents along the env axis, so GAE and minibatching reuse the
single-agent code (``frags_to_batch``) unchanged.
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import module as module_mod
from ray_tpu_torch.rllib.ppo import frags_to_batch, ppo_update
from ray_tpu_torch.train.step import ClippedAdam


class MultiAgentEnvRunner:
    """Samples one multi-agent env with per-policy parameter sets (CPU
    copies; the forward runs on the CPU, its draws from one generator per
    runner seeded from ``seed``).

    Assumes a fixed agent population per episode (the dict-API common
    case); agents absent from a step's obs dict are treated as done.
    """

    def __init__(self, env_maker: Callable, policy_mapping_fn: Callable,
                 seed: int = 0):
        self._env = env_maker()
        self._map = policy_mapping_fn
        self._seed = seed
        self._steps = 0
        self._generator = torch.Generator().manual_seed(seed)
        self._obs, _ = self._env.reset(seed=seed)
        self._agents = sorted(self._obs)
        self._live = set(self._agents)
        self._ep_return = {a: 0.0 for a in self._agents}
        self._completed: list[dict] = []

    def env_spec(self) -> Dict[str, dict]:
        """policy_id -> {obs_dim, n_actions, agents}."""
        out: Dict[str, dict] = {}
        for a in self._agents:
            pid = self._map(a)
            spec = out.setdefault(pid, {
                "obs_dim": int(np.asarray(self._obs[a]).size),
                "n_actions": int(self._env.action_space(a).n),
                "agents": []})
            spec["agents"].append(a)
        return out

    def sample(self, params_by_policy: Dict[str, Any],
               num_steps: int) -> Dict[str, dict]:
        """Per-policy fragments shaped like the single-agent runner's:
        [T, n_agents_of_policy, ...] so GAE/flattening reuse applies."""
        by_pid = {}
        for a in self._agents:
            by_pid.setdefault(self._map(a), []).append(a)
        bufs = {pid: {"obs": [], "actions": [], "logp": [], "values": [],
                      "rewards": [], "dones": []} for pid in by_pid}
        for _ in range(num_steps):
            actions: Dict[Any, int] = {}
            step_cache = {}
            for pid, agents in by_pid.items():
                obs = np.stack([np.asarray(self._obs[a], np.float32)
                                .reshape(-1) for a in agents])
                act, logp, value = module_mod.action_dist(
                    params_by_policy[pid], torch.from_numpy(obs),
                    self._generator)
                act = act.numpy().astype(np.int32)  # JAX's dtype
                step_cache[pid] = (obs, act, logp.numpy(), value.numpy())
                for i, a in enumerate(agents):
                    if a in self._live:  # strict dict envs reject
                        actions[a] = int(act[i])  # actions for the dead
            nobs, rews, terms, truncs, _ = self._env.step(actions)
            done_all = bool(terms.get("__all__")) or \
                bool(truncs.get("__all__"))
            for pid, agents in by_pid.items():
                obs, act, logp, value = step_cache[pid]
                r = np.asarray([float(rews.get(a, 0.0)) for a in agents],
                               np.float32)
                d = np.asarray(
                    [done_all or bool(terms.get(a)) or bool(truncs.get(a))
                     or a not in nobs  # PettingZoo-style early exit
                     for a in agents], bool)
                b = bufs[pid]
                b["obs"].append(obs)
                b["actions"].append(act)
                b["logp"].append(logp)
                b["values"].append(value)
                b["rewards"].append(r)
                b["dones"].append(d)
            for a in self._agents:
                self._ep_return[a] += float(rews.get(a, 0.0))
            if done_all:
                self._completed.append(dict(self._ep_return))
                self._obs, _ = self._env.reset()
                self._live = set(self._agents)
                self._ep_return = {a: 0.0 for a in self._agents}
            else:
                # an agent terminating early (dropped from the obs dict)
                # keeps its last observation: dones=True already cuts its
                # GAE trace, so the stale obs only pads the batch
                self._live = {a for a in self._agents if a in nobs}
                for a in self._live:
                    self._obs[a] = nobs[a]
            self._steps += 1
        out = {}
        for pid, agents in by_pid.items():
            b = bufs[pid]
            last_obs = np.stack([np.asarray(self._obs[a], np.float32)
                                 .reshape(-1) for a in agents])
            out[pid] = {k: np.stack(v) for k, v in b.items()}
            out[pid]["last_obs"] = last_obs
        return out

    def get_metrics(self) -> dict:
        done = self._completed
        self._completed = []
        return {"episode_returns": done}


@dataclass
class MultiAgentPPOConfig:
    """Reference: RLlib's ``AlgorithmConfig.multi_agent(policies=...,
    policy_mapping_fn=...)`` on top of ``PPOConfig.training()`` args."""

    env: Callable = None  # factory returning a MultiAgentEnv
    policy_mapping_fn: Callable = lambda agent_id: "default"
    num_env_runners: int = 1
    rollout_fragment_length: int = 64
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    entropy_coeff: float = 0.01
    vf_loss_coeff: float = 0.5
    grad_clip: float = 0.5
    lr: float = 5e-3
    num_epochs: int = 4
    minibatch_size: int = 128
    hidden: tuple = (64, 64)
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "MultiAgentPPO":
        if self.env is None:
            raise ValueError("MultiAgentPPOConfig.env factory is required")
        return MultiAgentPPO(self, device)


class MultiAgentPPO:
    """Independent PPO per policy id (one module per policy; policies
    shared by several agents arise from the mapping fn).  The learners'
    tensors live on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, config: MultiAgentPPOConfig,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        runner_cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.remote(config.env, config.policy_mapping_fn,
                              seed=config.seed + 1000 * i)
            for i in range(config.num_env_runners)]
        self.spec = ray_tpu_torch.get(self.runners[0].env_spec.remote(),
                                timeout=60)
        self.params: Dict[str, Any] = {}
        self.opt_state: Dict[str, Any] = {}
        generator = torch.Generator().manual_seed(config.seed)
        for pid, s in sorted(self.spec.items()):
            mcfg = module_mod.MLPConfig(
                obs_dim=s["obs_dim"], n_actions=s["n_actions"],
                hidden=config.hidden)
            self.params[pid] = module_mod.init_mlp(mcfg, generator,
                                                   self.device)
            self.opt_state[pid] = ClippedAdam().init(self.params[pid])
        self.iteration = 0
        self._timesteps = 0

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        host_params = {pid: module_mod.host_copy(p)
                       for pid, p in self.params.items()}
        params_ref = ray_tpu_torch.put(host_params)
        frags = ray_tpu_torch.get(
            [r.sample.remote(params_ref, cfg.rollout_fragment_length)
             for r in self.runners], timeout=600)
        t_sampled = time.perf_counter()
        stats_by_policy, learn_ms = {}, 0.0
        for i, pid in enumerate(sorted(self.params)):
            batch = frags_to_batch([f[pid] for f in frags],
                                   host_params[pid], cfg, self.device)
            n = int(batch["obs"].shape[0])
            self._timesteps += n
            t_learn = time.perf_counter()
            self.params[pid], self.opt_state[pid], stats = ppo_update(
                self.params[pid], self.opt_state[pid], batch,
                torch.Generator().manual_seed(
                    self.iteration * len(self.params) + i),
                num_epochs=cfg.num_epochs,
                minibatch_size=min(cfg.minibatch_size, n),
                clip=cfg.clip_param, ent_coeff=cfg.entropy_coeff,
                vf_coeff=cfg.vf_loss_coeff, grad_clip=cfg.grad_clip,
                lr=cfg.lr)
            stats_by_policy[pid] = {k: float(v) for k, v in stats.items()}
            learn_ms += (time.perf_counter() - t_learn) * 1e3
        self.iteration += 1
        metrics = ray_tpu_torch.get(
            [r.get_metrics.remote() for r in self.runners], timeout=60)
        episodes = [ep for m in metrics for ep in m["episode_returns"]]
        mean_return = (float(np.mean([sum(ep.values())
                                      for ep in episodes]))
                       if episodes else float("nan"))
        per_agent = {}
        if episodes:
            for a in episodes[0]:
                per_agent[str(a)] = float(
                    np.mean([ep[a] for ep in episodes]))
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps,
            "episode_return_mean": mean_return,
            "per_agent_return_mean": per_agent,
            "num_episodes": len(episodes),
            "policies": stats_by_policy,
            "num_updates": len(stats_by_policy),
            "time_this_iter_s": time.perf_counter() - t0,
            "sample_time_s": t_sampled - t0,
            "learn_time_ms": learn_ms,
        }

    # -- checkpointing ------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"params": module_mod.host_copy(self.params),
                         "opt_state": module_mod.host_copy(self.opt_state),
                         "iteration": self.iteration,
                         "timesteps": self._timesteps}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            st = pickle.load(f)
        self.params = module_mod.tree_to(st["params"], self.device)
        self.opt_state = module_mod.tree_to(st["opt_state"], self.device)
        self.iteration = st["iteration"]
        self._timesteps = st["timesteps"]

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
