"""Worker-side training context: get_context(), report(), get_checkpoint().

Counterpart of ``ray_tpu/train/context.py``.  The train function runs in
each worker process; ``report`` commits an optional checkpoint directory
to the experiment's storage and sends the metrics to the controller.  All
ranks must call report the same number of times (SPMD lockstep): the
controller barriers on report index, which is what commits a checkpoint.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_local = threading.local()


class TrainContext:
    def __init__(
        self,
        rank: int,
        local_rank: int,
        world_size: int,
        experiment_name: str,
        experiment_dir: str,
        outbox,
        stop_event,
        restore_checkpoint_path: Optional[str] = None,
        dataset_shards: Optional[dict] = None,
        start_report_index: int = 0,
        device: str = "cpu",
    ):
        """``outbox`` takes the reports (a ``multiprocessing`` queue the
        controller drains); ``stop_event`` is set by the controller to
        unwind the train function at its next report."""
        self.rank = rank
        self.local_rank = local_rank
        self.world_size = world_size
        self.experiment_name = experiment_name
        self.experiment_dir = experiment_dir
        self.restore_checkpoint_path = restore_checkpoint_path
        self.dataset_shards = dataset_shards or {}
        self.outbox = outbox
        self.stop_event = stop_event
        self.device = device
        # Seeded past the previous attempt's reports so checkpoint dirs from
        # a restarted run never collide with already-committed ones.
        self._report_index = start_report_index

    # -- public accessors (mirror ray.train.get_context()) ------------------
    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.world_size  # one host: every worker is local

    def get_node_rank(self) -> int:
        return 0

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_device(self) -> str:
        """The device this worker runs on (``cuda:<local rank>`` or
        ``cpu``)."""
        return self.device

    def get_dataset_shard(self, name: str = "train"):
        shard = self.dataset_shards.get(name)
        if shard is None:
            raise KeyError(f"no dataset shard named {name!r}")
        return shard

    # -- internals ----------------------------------------------------------
    def _next_report_index(self) -> int:
        idx = self._report_index
        self._report_index += 1
        return idx


def _set_context(ctx: Optional[TrainContext]):
    _local.ctx = ctx


def get_context() -> TrainContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError(
            "ray_tpu_torch.train.get_context() called outside a train "
            "function")
    return ctx


def get_checkpoint() -> Optional[Checkpoint]:
    """Latest committed checkpoint (set on restart)."""
    ctx = get_context()
    if ctx.restore_checkpoint_path and os.path.exists(
            ctx.restore_checkpoint_path):
        return Checkpoint(ctx.restore_checkpoint_path)
    return None


def get_dataset_shard(name: str = "train"):
    return get_context().get_dataset_shard(name)


def report(metrics: dict, checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (+ optionally persist a checkpoint) from a worker.

    A checkpoint directory inside the experiment's directory (where the
    ranks of a ``save_pytree`` wrote their shards together) is committed
    where it lies.  Any other is copied into the experiment's storage
    under ``checkpoint_{index:06d}``, ranks merging into one directory
    (existing files are not overwritten, so the first rank wins on
    collisions)."""
    ctx = get_context()
    idx = ctx._next_report_index()
    ckpt_rel = None
    if checkpoint is not None:
        root = os.path.abspath(ctx.experiment_dir)
        if os.path.commonpath([checkpoint.path, root]) == root:
            ckpt_rel = os.path.relpath(checkpoint.path, root)
        else:
            ckpt_rel = f"checkpoint_{idx:06d}"
            _merge_copy(checkpoint.path, os.path.join(root, ckpt_rel))
    ctx.outbox.put({
        "index": idx,
        "metrics": dict(metrics),
        "checkpoint_dir": ckpt_rel,
        "rank": ctx.rank,
    })
    if ctx.stop_event.is_set():
        raise _StopTraining()


class _StopTraining(BaseException):
    """Raised inside the train function to unwind on a controller stop."""


def _merge_copy(src: str, dest: str):
    os.makedirs(dest, exist_ok=True)
    for root, _dirs, files in os.walk(src):
        rel = os.path.relpath(root, src)
        out_root = dest if rel == "." else os.path.join(dest, rel)
        os.makedirs(out_root, exist_ok=True)
        for fname in files:
            out = os.path.join(out_root, fname)
            if not os.path.exists(out):
                try:
                    shutil.copy2(os.path.join(root, fname), out)
                except FileExistsError:
                    pass  # another rank won the race; identical-role file
