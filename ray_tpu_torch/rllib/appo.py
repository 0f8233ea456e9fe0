"""APPO: asynchronous PPO (decoupled sampling + clipped surrogate).

Counterpart of ``ray_tpu/rllib/appo.py`` (after RLlib's APPO: PPO's
clipped surrogate trained IMPALA-style on slightly stale samples).  The
asynchrony is pipelined futures: while the learner updates on batch N,
every runner is already sampling batch N+1 with the previous weights —
on-policy drift is one iteration deep, corrected by the clipped
importance ratio.  A PPO subclass overriding only the collection hook
(``_collect``): loss, batch prep, checkpointing and evaluation are
inherited, and the update stays ``ppo_update``; the overlap hides the
runners' env stepping behind the learner's update.
"""

from __future__ import annotations

from dataclasses import dataclass

import ray_tpu_torch
from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.rllib import module as module_mod
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig


@dataclass
class APPOConfig(PPOConfig):
    """Reference: RLlib's ``APPOConfig``.  Fewer update epochs than PPO by
    default: the data is one iteration stale."""

    num_epochs: int = 2

    def build(self, device: DeviceLike = None) -> "APPO":
        return APPO(self, device)


class APPO(PPO):
    """PPO with pipelined (async) sampling."""

    def __init__(self, config: APPOConfig, device: DeviceLike = None):
        super().__init__(config, device)
        # futures for the batch being sampled right now, and the (CPU)
        # weights it is being sampled with (the behavior policy)
        self._inflight = None
        self._inflight_params = None

    def _launch_sampling(self):
        behavior = module_mod.host_copy(self.params)
        params_ref = ray_tpu_torch.put(behavior)
        self._inflight = [
            r.sample.remote(params_ref,
                            self.config.rollout_fragment_length)
            for r in self.runners]
        self._inflight_params = behavior

    def _collect(self):
        if self._inflight is None:
            self._launch_sampling()
        frags = ray_tpu_torch.get(self._inflight, timeout=600)
        behavior_params = self._inflight_params
        # the next batch starts sampling now, with the weights the learner
        # is about to update away from (the APPO staleness); the batch
        # carries the behavior logp, which the clipped ratio corrects
        self._launch_sampling()
        return frags, behavior_params
