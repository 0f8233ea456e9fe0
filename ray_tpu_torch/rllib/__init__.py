"""ray_tpu_torch.rllib: reinforcement learning with the learners on the
device.

Counterpart of ``ray_tpu/rllib``: the online algorithms (PPO, APPO,
IMPALA, DQN, SAC, multi-agent PPO, DreamerV3) with the env-runner path
they sample through, and the offline ones (BC, MARWIL, CQL) over episode
lists or any ``iter_batches`` source.  The learners' tensors live on CUDA
unless the caller passes ``device="cpu"``; the env runners run on threads
of their own (``_actors.py``, the stand-in for the runtime's actors) and
compute their forward on the CPU from a CPU copy of the parameters.
Exports what the JAX package's ``rllib`` exports.
"""

from ray_tpu_torch.rllib.bc import BC, BCConfig, MARWILConfig
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.dreamerv3 import DreamerV3, DreamerV3Config
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
    "BC",
    "BCConfig",
    "MARWILConfig",
    "DQN",
    "DQNConfig",
    "DreamerV3",
    "DreamerV3Config",
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
