"""Train controller: drives the worker group, commits checkpoints, retries.

Counterpart of ``ray_tpu/train/controller.py``: poll workers -> barrier
reports per index -> commit checkpoints (and fire the trainer's
callbacks) -> on a worker's exception or death consult ``FailureConfig``
and either rebuild the group from the latest committed checkpoint, at the
largest size down to ``ScalingConfig.min_workers`` that can be placed, or
surface the error in the ``Result``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    PlacementGroupUnavailableError,
    RayTpuError,
)
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclass
class Result:
    """Outcome of a training run."""

    metrics: Optional[dict] = None
    checkpoint: Optional[Checkpoint] = None
    path: Optional[str] = None
    error: Optional[Exception] = None
    best_checkpoints: list = field(default_factory=list)


class TrainingFailedError(RayTpuError):
    pass


def default_storage_path() -> str:
    return os.environ.get(
        "RAY_TPU_STORAGE_PATH",
        os.path.join(os.path.expanduser("~"), "ray_tpu_results"))


class TrainController:
    """Runs one training job to completion, in the calling process."""

    POLL_INTERVAL_S = 0.05

    def __init__(
        self,
        train_fn: Callable,
        train_loop_config: Optional[dict],
        scaling_config: ScalingConfig,
        run_config: RunConfig,
        dataset_factory: Optional[Callable[[int], list]] = None,
        trial_info: Optional[dict] = None,
        callbacks: Optional[list] = None,
        group_options: Optional[dict] = None,
    ):
        """``callbacks``: each is called as ``cb(index, metrics,
        checkpoint)`` once every rank delivered report ``index``, with the
        committed checkpoint or None.  ``group_options``: the
        ``WorkerGroup``'s process-group options (``backend``,
        ``timeout_s``)."""
        self._train_fn = train_fn
        self._group_options = group_options or {}
        self._config = train_loop_config
        self._scaling = scaling_config
        self._run_config = run_config
        self._dataset_factory = dataset_factory
        self._trial_info = trial_info
        self._callbacks = callbacks or []
        name = run_config.name or f"train_{int(time.time())}"
        storage = run_config.storage_path or default_storage_path()
        self._experiment_dir = os.path.join(storage, name)
        os.makedirs(self._experiment_dir, exist_ok=True)
        self._name = name
        self._ckpt_manager = CheckpointManager(
            self._experiment_dir, run_config.checkpoint_config)
        self._latest_metrics: Optional[dict] = None
        # Global report counter across attempts: seeds each attempt's
        # worker-side report index so checkpoint dirs never collide with a
        # previous attempt's committed ones. On controller resume, start
        # past the latest committed checkpoint.
        self._next_report_index = self._ckpt_manager.latest_index + 1

    @property
    def experiment_dir(self) -> str:
        return self._experiment_dir

    def run(self) -> Result:
        max_failures = self._run_config.failure_config.max_failures
        attempt = 0
        while True:
            error = self._run_attempt()
            if error is None:
                return self._result(None)
            attempt += 1
            if max_failures >= 0 and attempt > max_failures:
                return self._result(
                    TrainingFailedError(
                        f"training failed after {attempt} attempt(s): {error}"))
            # else: elastic restart from the latest committed checkpoint

    # -- internals ----------------------------------------------------------
    def _start_group_elastic(self, restore, shards_factory,
                             shards_cache: dict):
        """Gang up at the largest placeable world size.

        Every attempt first tries the full num_workers, so a recovered
        cluster scales back up, then steps down toward min_workers when
        the placement group cannot be reserved (capacity died with a
        node).  The FULL size gets a few quick retries before any
        downsizing: the previous attempt's bundles may still be
        releasing, and a transient reservation race must not demote the
        whole remaining run to a smaller gang.
        """
        want = self._scaling.num_workers
        floor = (want if self._scaling.min_workers is None
                 else self._scaling.min_workers)
        for n in range(want, floor - 1, -1):
            tries = 3 if n == want else 1
            for attempt in range(tries):
                group = WorkerGroup(self._scaling, num_workers=n,
                                    **self._group_options)
                if n not in shards_cache:
                    shards_cache[n] = shards_factory(n)
                try:
                    group.start(self._name, self._experiment_dir, restore,
                                shards_cache[n], self._trial_info,
                                self._next_report_index)
                    return group
                except PlacementGroupUnavailableError:
                    group.shutdown(graceful=False)
                    if attempt < tries - 1:
                        time.sleep(1.0)
                    continue  # retry / re-mesh smaller
                except BaseException:
                    group.shutdown(graceful=False)
                    raise
        return None  # nothing >= floor placeable right now

    def _run_attempt(self) -> Optional[str]:
        latest = self._ckpt_manager.latest_checkpoint
        restore = latest.path if latest is not None else None

        def shards_factory(n: int):
            # re-shard datasets for the ACTUAL world size of this attempt
            return (self._dataset_factory(n)
                    if self._dataset_factory is not None else None)

        floor = (self._scaling.num_workers
                 if self._scaling.min_workers is None
                 else self._scaling.min_workers)
        deadline = time.monotonic() + self._scaling.placement_timeout_s
        shards_cache: dict = {}
        group = None
        try:
            while group is None:
                group = self._start_group_elastic(restore, shards_factory,
                                                  shards_cache)
                if group is None:
                    if time.monotonic() > deadline:
                        return ("could not place a worker group of size "
                                f">= {floor}")
                    # transient: bundles releasing / node death not yet
                    # observed; capacity may return
                    time.sleep(self._scaling.placement_retry_interval_s)
            group.run(self._train_fn, self._config)
            return self._poll_until_done(group)
        except (ActorDiedError, ActorUnavailableError, RayTpuError) as e:
            return str(e)
        finally:
            if group is not None:
                group.shutdown()
            # the next attempt re-splits: end this one's split coordinators
            # (the JAX package's live on with the session)
            from ray_tpu_torch.data.split import kill_coordinators

            kill_coordinators(list(shards_cache.values()))

    def _poll_until_done(self, group: WorkerGroup) -> Optional[str]:
        n = group.num_workers
        # pending[rank] = list of not-yet-consumed reports, ordered by index
        pending: list[list[dict]] = [[] for _ in range(n)]
        consumed = 0
        while True:
            polls = group.poll()  # raises if a worker actor died
            for rank, p in enumerate(polls):
                pending[rank].extend(p["reports"])
            # Barrier: process report index i once every rank delivered it.
            while all(len(q) > consumed for q in pending):
                reports = [q[consumed] for q in pending]
                self._process_report(reports)
                consumed += 1
            errors = [p["error"] for p in polls if p["error"]]
            if errors:
                # Ask surviving ranks to unwind at their next report()
                # instead of being killed mid-checkpoint-write.
                group.stop()
                return errors[0]
            if all(p["done"] for p in polls):
                # drain any final lockstep reports already buffered
                while all(len(q) > consumed for q in pending):
                    reports = [q[consumed] for q in pending]
                    self._process_report(reports)
                    consumed += 1
                return None
            time.sleep(self.POLL_INTERVAL_S)

    def _process_report(self, reports: list[dict]):
        rank0 = next(r for r in reports if r["rank"] == 0)
        index = rank0["index"]
        self._next_report_index = index + 1
        self._latest_metrics = rank0["metrics"]
        ckpt_dirs = {r["checkpoint_dir"] for r in reports
                     if r["checkpoint_dir"]}
        for rel in sorted(ckpt_dirs):
            path = os.path.join(self._experiment_dir, rel)
            self._ckpt_manager.register_checkpoint(
                path, rank0["metrics"], index)
        for cb in self._callbacks:
            cb(index, rank0["metrics"],
               self._ckpt_manager.latest_checkpoint if ckpt_dirs else None)

    def _result(self, error: Optional[Exception]) -> Result:
        return Result(
            metrics=self._latest_metrics,
            checkpoint=self._ckpt_manager.latest_checkpoint,
            path=self._experiment_dir,
            error=error,
            best_checkpoints=self._ckpt_manager.best_checkpoints(),
        )
