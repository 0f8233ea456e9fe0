"""Training: the sharded train step and its optimizer, the trainer, its
controller and worker actors, checkpoints, and the Llama-3 8B recipe.

Counterpart of ``ray_tpu/train``, less ``JaxTrainer`` (whose counterpart
is ``DataParallelTrainer``, the base of the gradient-boosting trainers
here).  A controller in the calling
process drives one worker actor per GPU, each in a bundle of one
placement group of the port's runtime; the ranks form one
``torch.distributed`` process group, build a ``DeviceMesh`` over it and
run the sharded step (``train.step``).  Reports and checkpoints flow
through the experiment's storage; tensor trees through
``torch.distributed.checkpoint``.
"""

from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.context import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.controller import (
    Result,
    TrainController,
    TrainingFailedError,
)
from ray_tpu_torch.train.gbdt import LightGBMTrainer, XGBoostTrainer
from ray_tpu_torch.train.step import (
    create_train_state,
    data_sharding,
    default_optimizer,
    make_train_step,
)
from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer
from ray_tpu_torch.train.trainer import DataParallelTrainer
from ray_tpu_torch.train.worker_group import TrainWorker, WorkerGroup

__all__ = [
    "Checkpoint", "CheckpointConfig", "CheckpointManager",
    "DataParallelTrainer", "FailureConfig", "LightGBMTrainer", "Result",
    "RunConfig", "ScalingConfig", "TorchConfig", "TorchTrainer",
    "TrainContext", "TrainController", "TrainWorker", "XGBoostTrainer",
    "TrainingFailedError", "WorkerGroup", "create_train_state",
    "data_sharding", "default_optimizer", "get_checkpoint", "get_context",
    "get_dataset_shard", "load_pytree", "make_train_step", "report",
    "save_pytree",
]
