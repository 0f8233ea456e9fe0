"""ray_tpu_torch.rllib: online reinforcement learning with the learners on
the device.

Counterpart of ``ray_tpu/rllib``'s online algorithms (PPO, APPO, IMPALA,
DQN, SAC, multi-agent PPO) and the env-runner path they sample through.
The learners' tensors live on CUDA unless the caller passes
``device="cpu"``; the env runners run on threads of their own
(``_actors.py``, the stand-in for the runtime's actors) and compute their
forward on the CPU from a CPU copy of the parameters.  Exports the online
subset of the JAX package's ``rllib`` exports.
"""

from ray_tpu_torch.rllib.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.module import (
    MLPConfig,
    forward,
    greedy_action,
    init_mlp,
)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, compute_gae
from ray_tpu_torch.rllib.replay_buffers import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
)

__all__ = [
    "DQN",
    "DQNConfig",
    "EnvRunner",
    "IMPALA",
    "IMPALAConfig",
    "MLPConfig",
    "PPO",
    "PrioritizedReplayBuffer",
    "ReplayBuffer",
    "PPOConfig",
    "compute_gae",
    "forward",
    "greedy_action",
    "init_mlp",
]
