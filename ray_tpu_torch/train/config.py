"""User-facing Train configuration dataclasses.

Counterpart of ``ray_tpu/train/config.py`` (a copy: the port imports
nothing of the JAX package).  The accelerator is the GPU: a worker of
rank ``r`` on a host runs on ``cuda:<local rank>`` with NCCL, unless
``use_gpu=False`` asks for the CPU and gloo, which is how the tests run.
The JAX package's slice topology and placement-group options have no
counterpart: the port's workers are local processes, one per GPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ScalingConfig:
    """Shape of the worker group.

    num_workers: one worker process per GPU (torch's idiom; the JAX
    package runs one worker per host driving every local chip).
    use_gpu: each worker runs on ``cuda:<local rank>`` with NCCL; False
    runs them on the CPU with gloo.
    """

    num_workers: int = 1
    use_gpu: bool = True

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got "
                             f"{self.num_workers}")

    def device(self, local_rank: int) -> str:
        """The device a worker of ``local_rank`` runs on."""
        return f"cuda:{local_rank}" if self.use_gpu else "cpu"

    @property
    def backend(self) -> str:
        """The ``torch.distributed`` backend of the group."""
        return "nccl" if self.use_gpu else "gloo"


@dataclass
class FailureConfig:
    """How the controller reacts to worker failures.

    max_failures: group restarts allowed (-1 = unlimited).  On restart the
    group is rebuilt and the train fn re-invoked with the latest committed
    checkpoint visible via ``ray_tpu_torch.train.get_checkpoint()``.
    """

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Top-K checkpoint retention."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # or "min"

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    """Where results/checkpoints go and how failures are handled."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
