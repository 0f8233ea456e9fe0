"""TorchTrainer: a user's torch.distributed train loop on the worker group.

Counterpart of ``ray_tpu/train/torch.py``.  The JAX package's wrapper
forms a process group around the user's function, because its workers
join none.  The port's worker actors already join one in their ``setup``
and set the variables a torch program reads (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``;
``train/worker_group.py``).  So ``TorchTrainer`` is the
``DataParallelTrainer`` whose group takes ``TorchConfig``'s backend,
timeout, address and port; it forms no second group.  The address
defaults to this host's peer-routable one and the port to a free one, as
the JAX package's.  ``prepare_model`` and ``prepare_data_loader`` are the
JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import DataParallelTrainer


@dataclass
class TorchConfig:
    """The process group's backend (None: the worker group's, NCCL on GPUs
    and gloo on the CPU), where it forms, and its collectives' timeout.
    As in the JAX package, the port is reserved on the host that calls
    ``fit()``, so rank 0 must run where it is also free; set both for
    ranks on several hosts."""

    backend: Optional[str] = None
    master_addr: Optional[str] = None  # default: this host's (worker_group)
    master_port: Optional[int] = None  # default: a free port, at fit()
    timeout_s: float = 1800.0


class TorchTrainer(DataParallelTrainer):
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        torch_config: Optional[TorchConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[dict] = None,
        callbacks: Optional[list] = None,
    ):
        """Raises where ``scaling_config.use_gpu`` (the default) asks for
        GPUs and CUDA is not available."""
        import torch

        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            callbacks=callbacks,
        )
        if self._scaling_config.use_gpu and not torch.cuda.is_available():
            raise RuntimeError(
                "ScalingConfig(use_gpu=True) needs CUDA, which is not "
                "available; ScalingConfig(use_gpu=False) runs on the CPU")
        torch_config = torch_config or TorchConfig()
        self._group_options = {"backend": torch_config.backend,
                               "timeout_s": torch_config.timeout_s,
                               "master_addr": torch_config.master_addr,
                               "master_port": torch_config.master_port}


def prepare_model(model, parallel_strategy: str = "ddp"):
    """Wrap an ``nn.Module`` for data-parallel training: itself at world
    size 1, else DDP (on the worker's GPU where it has one) or FSDP."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return model
    if parallel_strategy == "ddp":
        from torch.nn.parallel import DistributedDataParallel

        on_gpu = next(model.parameters()).is_cuda
        return DistributedDataParallel(
            model, device_ids=[torch.cuda.current_device()] if on_gpu
            else None)
    if parallel_strategy == "fsdp":
        from torch.distributed.fsdp import FullyShardedDataParallel

        return FullyShardedDataParallel(model)
    raise ValueError(f"unknown parallel_strategy {parallel_strategy!r}")


def prepare_data_loader(loader):
    """Shard a DataLoader across ranks with a DistributedSampler.

    Preserves the loader's shuffle intent, num_workers, pin_memory,
    collate_fn, and drop_last.  For per-epoch reshuffling call
    ``loader.sampler.set_epoch(epoch)`` each epoch."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader, RandomSampler
    from torch.utils.data.distributed import DistributedSampler

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return loader
    was_shuffling = isinstance(loader.sampler, RandomSampler)
    sampler = DistributedSampler(loader.dataset, shuffle=was_shuffling)
    return DataLoader(
        loader.dataset, batch_size=loader.batch_size, sampler=sampler,
        num_workers=loader.num_workers, pin_memory=loader.pin_memory,
        collate_fn=loader.collate_fn, drop_last=loader.drop_last)
