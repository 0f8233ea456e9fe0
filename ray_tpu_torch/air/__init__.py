"""ray_tpu_torch.air: shared AIR commons for Train and Tune.

Counterpart of ``ray_tpu/air/``; that is, of the reference's
(Ray's python/ray/air/): the run/checkpoint/failure configs and Result
type shared by the AI libraries (re-exported from their canonical homes
here), plus the execution layer (``air.execution.ActorManager``, the
reference's ``RayActorManager``,
python/ray/air/execution/_internal/actor_manager.py:22) that Tune's trial
loop runs on.
"""

from ray_tpu_torch.air.execution import ActorManager, TrackedActor
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.controller import Result

__all__ = [
    "ActorManager",
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TrackedActor",
]
