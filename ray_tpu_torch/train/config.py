"""User-facing Train configuration dataclasses.

Counterpart of ``ray_tpu/train/config.py`` (a copy: the port imports
nothing of the JAX package).  The accelerator is the GPU: each worker is
a runtime actor in one bundle of a placement group (``bundle()``:
``{"CPU": 1, "GPU": 1}`` by default) and runs on ``cuda:0``, the one card
its grant leaves visible, with NCCL, unless ``use_gpu=False`` asks for
``{"CPU": 1}`` bundles and gloo, which is how the tests run.  The JAX
package's slice topology and ``jax.distributed`` options have no
counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ScalingConfig:
    """Shape of the worker group.

    num_workers: one worker actor per GPU (torch's idiom; the JAX package
    runs one worker per host driving every local chip).
    use_gpu: each worker's bundle holds one GPU and the worker runs on
    ``cuda:0`` with NCCL; False runs them on the CPU with gloo.
    resources_per_worker: resource bundle per worker, default 1 CPU (plus
    1 GPU under ``use_gpu`` unless the dict names ``GPU``).
    """

    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: Optional[dict] = None
    placement_strategy: str = "STRICT_PACK"
    # Elastic lower bound: after a failure, if the full num_workers gang
    # can no longer be placed (capacity left with a dead node), the
    # controller rebuilds at the largest placeable size >= min_workers and
    # restores from the latest committed checkpoint.  None = fixed-size
    # (the default).
    min_workers: Optional[int] = None
    # How long one attempt waits for ANY placeable size >= min_workers
    # before counting a failure, and how often it rechecks.
    placement_timeout_s: float = 120.0
    placement_retry_interval_s: float = 1.0

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got "
                             f"{self.num_workers}")
        if self.min_workers is not None and not (
                1 <= self.min_workers <= self.num_workers):
            raise ValueError(
                f"min_workers must be in [1, num_workers={self.num_workers}]"
                f", got {self.min_workers}")

    def bundle(self) -> dict:
        """One worker's bundle of the group's placement group."""
        res = dict(self.resources_per_worker or {"CPU": 1})
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1
        return res

    @property
    def device(self) -> str:
        """The device a worker runs on: under its grant an actor sees
        only its own card, which is ``cuda:0`` there."""
        return "cuda:0" if self.use_gpu else "cpu"

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
