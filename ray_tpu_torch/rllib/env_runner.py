"""EnvRunner: the sampling actor collecting rollouts from gymnasium-style
envs.

Counterpart of ``ray_tpu/rllib/env_runner.py`` (after RLlib's
``SingleAgentEnvRunner``): each runner owns ``num_envs`` environments,
steps them with the policy parameters the algorithm hands it, and returns
fixed-length fragments plus episode metrics.  The forward runs on the CPU
from the CPU copy of the parameters it was given, as the JAX runners run
on host copies (``jax.device_get``).  Its draws come from one
``torch.Generator`` per runner, seeded from the runner's seed, where the
JAX runner makes a fresh key from (seed, step) at every step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Union

import numpy as np
import torch

from ray_tpu_torch.rllib import module as module_mod


class EnvRunner:
    def __init__(self, env_maker: Union[str, Callable], num_envs: int = 1,
                 seed: int = 0, env_to_module=None):
        """env_maker: a gymnasium id (gymnasium is imported only then) or a
        callable returning an env with the gymnasium 5-tuple API.
        env_to_module: optional ConnectorPipeline (``connectors.py``)
        applied to observation batches before the module forward and to
        reward vectors before they enter returns/batches."""
        if isinstance(env_maker, str):
            import gymnasium as gym

            self._envs = [gym.make(env_maker) for _ in range(num_envs)]
        else:
            self._envs = [env_maker() for _ in range(num_envs)]
        self._connectors = env_to_module
        self._obs = []
        for i, env in enumerate(self._envs):
            obs, _ = env.reset(seed=seed + i)
            self._obs.append(obs)
        self._ep_return = [0.0] * num_envs
        self._ep_len = [0] * num_envs
        self._completed_returns: List[float] = []
        self._completed_lens: List[int] = []
        self._seed = seed
        self._steps = 0
        self._generator = torch.Generator().manual_seed(seed)

    def env_spec(self) -> Dict[str, int]:
        env = self._envs[0]
        return {"obs_dim": int(np.prod(env.observation_space.shape)),
                "n_actions": int(env.action_space.n)}

    def _finish_episode(self, i: int, env) -> Any:
        self._completed_returns.append(self._ep_return[i])
        self._completed_lens.append(self._ep_len[i])
        self._ep_return[i], self._ep_len[i] = 0.0, 0
        return env.reset()[0]

    def sample(self, params, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect ``num_steps`` per env with the given (CPU) params."""
        n = len(self._envs)
        obs_buf, act_buf, logp_buf, val_buf = [], [], [], []
        rew_buf, done_buf = [], []
        truncated_next: list = []  # (t, env_idx, next_obs) at truncations
        for t in range(num_steps):
            obs = np.stack(self._obs).astype(np.float32)
            if self._connectors is not None:
                obs = self._connectors.transform_obs(obs)
            action, logp, value = module_mod.action_dist(
                params, torch.from_numpy(obs), self._generator)
            action = action.numpy().astype(np.int32)  # JAX's dtype
            obs_buf.append(obs)
            act_buf.append(action)
            logp_buf.append(logp.numpy())
            val_buf.append(value.numpy())
            rews, dones = np.zeros(n, np.float32), np.zeros(n, bool)
            for i, env in enumerate(self._envs):
                nobs, r, term, trunc, _ = env.step(int(action[i]))
                rews[i] = r
                self._ep_return[i] += float(r)
                self._ep_len[i] += 1
                if term or trunc:
                    dones[i] = True
                    if trunc and not term:
                        # a time-limit truncation is not an absorbing
                        # state: bootstrap with V(s'), folded into the
                        # reward by the learner (dones still cuts the
                        # trace there)
                        truncated_next.append(
                            (t, i, np.asarray(nobs, np.float32)))
                    nobs = self._finish_episode(i, env)
                self._obs[i] = nobs
            if self._connectors is not None:
                rews = self._connectors.transform_rewards(rews)
            rew_buf.append(rews)
            done_buf.append(dones)
            self._steps += 1
        last_obs = np.stack(self._obs).astype(np.float32)
        if self._connectors is not None:
            # update=False: these observations re-enter (with update=True)
            # as the first step of the next sample() call
            last_obs = self._connectors.transform_obs(last_obs,
                                                      update=False)
        # V(s') at time-limit truncations, zero elsewhere
        trunc_values = np.zeros((num_steps, n), np.float32)
        if truncated_next:
            batch = np.stack([o for _, _, o in truncated_next])
            if self._connectors is not None:
                # discarded-by-reset states: project, never accumulate
                batch = self._connectors.transform_obs(batch,
                                                       update=False)
            v = module_mod.host_values(params, batch)
            for k, (t, i, _) in enumerate(truncated_next):
                trunc_values[t, i] = v[k]
        return {
            "obs": np.stack(obs_buf),          # [T, n, obs_dim]
            "actions": np.stack(act_buf),       # [T, n]
            "logp": np.stack(logp_buf),         # [T, n]
            "values": np.stack(val_buf),        # [T, n]
            "rewards": np.stack(rew_buf),       # [T, n]
            "dones": np.stack(done_buf),        # [T, n]
            "trunc_values": trunc_values,       # [T, n]
            "last_obs": last_obs,               # [n, obs_dim]
        }

    def sample_transitions(self, params, num_steps: int,
                           epsilon: float = 0.0,
                           policy: str = "greedy") -> Dict[str, np.ndarray]:
        """Off-policy collection: flat transition tuples for replay buffers.

        policy="greedy": epsilon-greedy over Q = logits head (DQN).
        policy="softmax": sample from the Boltzmann policy over the logits
        head (discrete SAC).  The draws come from the same numpy generator
        as the JAX runner's.

        Returns {obs, actions, rewards, next_obs, dones}, each
        [num_steps * n_envs, ...].
        """
        n = len(self._envs)
        rng = np.random.default_rng(self._seed * 77003 + self._steps)
        obs_b, act_b, rew_b, nobs_b, done_b = [], [], [], [], []
        for _ in range(num_steps):
            obs = np.stack(self._obs).astype(np.float32)
            if self._connectors is not None:
                obs = self._connectors.transform_obs(obs)
            with torch.no_grad():
                q = module_mod.forward(params, torch.from_numpy(obs))[0]
            q = q.numpy()
            if policy == "softmax":
                z = q - q.max(axis=-1, keepdims=True)
                p = np.exp(z)
                p /= p.sum(axis=-1, keepdims=True)
                action = np.array([rng.choice(q.shape[-1], p=p[i])
                                   for i in range(n)])
            else:
                action = np.argmax(q, axis=-1)
                explore = rng.random(n) < epsilon
                action = np.where(
                    explore, rng.integers(0, q.shape[-1], size=n), action)
            for i, env in enumerate(self._envs):
                nobs, r, term, trunc, _ = env.step(int(action[i]))
                self._ep_return[i] += float(r)
                self._ep_len[i] += 1
                obs_b.append(obs[i])
                act_b.append(int(action[i]))
                rew_b.append(float(r))
                # a time-limit truncation is not an absorbing state:
                # done=0, so the target bootstraps from next_obs
                done_b.append(bool(term))
                nobs_b.append(np.asarray(nobs, np.float32))
                if term or trunc:
                    nobs = self._finish_episode(i, env)
                self._obs[i] = nobs
            self._steps += 1
        next_obs = np.stack(nobs_b).astype(np.float32)
        rewards = np.asarray(rew_b, np.float32)
        if self._connectors is not None:
            # re-project next_obs with the same filter state (they were
            # counted when they became current obs on the next step)
            next_obs = self._connectors.transform_obs(next_obs,
                                                      update=False)
            rewards = self._connectors.transform_rewards(rewards)
        return {
            "obs": np.stack(obs_b).astype(np.float32),
            "actions": np.asarray(act_b, np.int32),
            "rewards": rewards,
            "next_obs": next_obs,
            "dones": np.asarray(done_b, np.float32),
        }

    def get_metrics(self) -> Dict[str, Any]:
        out = {"episode_returns": list(self._completed_returns),
               "episode_lens": list(self._completed_lens)}
        self._completed_returns, self._completed_lens = [], []
        return out
