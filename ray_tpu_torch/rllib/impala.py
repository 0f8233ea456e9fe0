"""IMPALA: asynchronous sampling actors + a V-trace learner on the device.

Counterpart of ``ray_tpu/rllib/impala.py`` (after RLlib's IMPALA, the
importance-weighted actor-learner architecture): env-runner actors sample
with a stale behavior policy while the learner updates continuously; the
lag is corrected with V-trace (Espeholt et al. 2018).  JAX runs V-trace's
recursion as a reversed ``lax.scan``; here it is a reversed loop over T.
Sampling overlaps learning through ``ray_tpu_torch.wait`` on the
runner actors' rollouts in flight.
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
from ray_tpu_torch.train.step import ClippedAdam


@dataclass
class IMPALAConfig:
    """Reference: RLlib's ``IMPALAConfig``."""

    env: Union[str, Callable] = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_fragment_length: int = 64
    gamma: float = 0.99
    lr: float = 5e-4
    grad_clip: float = 40.0
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    # V-trace clipping (rho_bar governs the value target bias, c_bar the
    # trace cutting; 1.0/1.0 are the paper's defaults)
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    # how many rollout futures to keep in flight per runner
    max_requests_in_flight: int = 2
    hidden: tuple = (64, 64)
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "IMPALA":
        return IMPALA(self, device)


def vtrace_minus_v(deltas, discounts, clipped_c):
    """vs_t - V(s_t) for [T, B] inputs by the reversed recursion
    ``acc_t = delta_t + discount_t * c_t * acc_{t+1}``, ``acc_T = 0``."""
    acc = torch.zeros_like(deltas[0])
    out = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * clipped_c[t] * acc
        out.append(acc)
    return torch.stack(out[::-1])


def _impala_loss(p, batch, gamma, rho_clip, c_clip, vf_coeff, ent_coeff):
    T, B = batch["actions"].shape
    logits, values = module_mod.forward(p, batch["obs"].reshape(T * B, -1))
    logits = logits.reshape(T, B, -1)
    values = values.reshape(T, B)
    _, last_value = module_mod.forward(p, batch["last_obs"])   # [B]

    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["actions"][..., None])[..., 0]
    # importance ratios against the behavior policy that sampled
    rhos = torch.exp(logp - batch["behavior_logp"])
    clipped_rho = torch.clamp(rhos, max=rho_clip)
    clipped_c = torch.clamp(rhos, max=c_clip)

    # the V-trace targets and advantages take no gradient (JAX's
    # stop_gradient), so autograd records none of the recursion
    with torch.no_grad():
        discounts = gamma * (1.0 - batch["dones"])             # [T, B]
        values_tp1 = torch.cat([values[1:], last_value[None]], dim=0)
        deltas = clipped_rho * (
            batch["rewards"] + discounts * values_tp1 - values)
        vs = vtrace_minus_v(deltas, discounts, clipped_c) + values
        vs_tp1 = torch.cat([vs[1:], last_value[None]], dim=0)
        pg_adv = clipped_rho * (
            batch["rewards"] + discounts * vs_tp1 - values)

    pg_loss = -torch.mean(logp * pg_adv)
    vf_loss = 0.5 * torch.mean((vs - values) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    loss = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return loss, (pg_loss, vf_loss, entropy, torch.mean(rhos))


def _impala_update(params, opt_state, batch, *, lr, grad_clip, gamma,
                   rho_clip, c_clip, vf_coeff, ent_coeff):
    """One V-trace update on the device of ``batch``: ``params`` and
    ``opt_state`` in place; returns them with the loss and (pg_loss,
    vf_loss, entropy, mean_rho) as 0-d tensors."""
    p = module_mod.trainable(params)
    loss, aux = _impala_loss(p, batch, gamma, rho_clip, c_clip, vf_coeff,
                             ent_coeff)
    ClippedAdam(learning_rate=lr, grad_clip=grad_clip).update(
        params, module_mod.gradients(loss, p), opt_state)
    return params, opt_state, loss.detach(), tuple(a.detach() for a in aux)


class IMPALA:
    """Tune-compatible trainable: train() -> result dict.  The learner's
    tensors live on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, config: IMPALAConfig, device: DeviceLike = None):
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
        self.opt_state = ClippedAdam().init(self.params)
        self._iter = 0
        self._env_steps = 0
        # rollout refs in flight, each sampled with the params of its
        # submission (V-trace corrects the staleness)
        self._inflight: Dict[Any, Any] = {}
        for r in self._runners:
            for _ in range(config.max_requests_in_flight):
                self._submit(r)

    def _submit(self, runner):
        ref = runner.sample.remote(module_mod.host_copy(self.params),
                                   self.config.rollout_fragment_length)
        self._inflight[ref.binary()] = (ref, runner)

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        losses, aux_last, learn_ms = [], None, 0.0
        for _ in range(max(1, c.num_env_runners)):
            refs = [ref for ref, _ in self._inflight.values()]
            ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=120)
            if not ready:
                break
            ref = ready[0]
            _, runner = self._inflight.pop(ref.binary())
            rollout = ray_tpu_torch.get(ref, timeout=60)
            self._submit(runner)  # keep the pipeline full
            t_learn = time.perf_counter()
            cols = {
                "obs": rollout["obs"],                      # [T, n, d]
                "actions": rollout["actions"].astype(np.int64),
                "behavior_logp": rollout["logp"],
                "rewards": (rollout["rewards"]
                            + c.gamma * rollout["trunc_values"]),
                "dones": rollout["dones"].astype(np.float32),
                "last_obs": rollout["last_obs"],
            }
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in cols.items()}
            self.params, self.opt_state, loss, aux = _impala_update(
                self.params, self.opt_state, batch,
                lr=c.lr, grad_clip=c.grad_clip, gamma=c.gamma,
                rho_clip=c.vtrace_rho_clip, c_clip=c.vtrace_c_clip,
                vf_coeff=c.vf_loss_coeff, ent_coeff=c.entropy_coeff)
            losses.append(float(loss))  # waits for the update
            learn_ms += (time.perf_counter() - t_learn) * 1e3
            aux_last = aux
            self._env_steps += (c.rollout_fragment_length
                                * c.num_envs_per_runner)

        metrics = ray_tpu_torch.get(
            [r.get_metrics.remote() for r in self._runners], timeout=60)
        returns = [x for m in metrics for x in m["episode_returns"]]
        self._iter += 1
        out = {
            "training_iteration": self._iter,
            "env_steps_sampled": self._env_steps,
            "loss": float(np.mean(losses)) if losses else None,
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else None),
            "time_this_iter_s": time.perf_counter() - t0,
            "num_updates": len(losses),
            "learn_time_ms": learn_ms,
        }
        if aux_last is not None:
            pg, vf, ent, rho = aux_last
            out.update(pg_loss=float(pg), vf_loss=float(vf),
                       entropy=float(ent), mean_rho=float(rho))
        return out

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"params": module_mod.host_copy(self.params),
                         "opt_state": module_mod.host_copy(self.opt_state),
                         "iter": self._iter,
                         "env_steps": self._env_steps}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.params = module_mod.tree_to(state["params"], self.device)
        self.opt_state = module_mod.tree_to(state["opt_state"], self.device)
        self._iter = state["iter"]
        self._env_steps = state["env_steps"]

    def stop(self) -> None:
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
