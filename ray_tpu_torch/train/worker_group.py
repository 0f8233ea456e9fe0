"""Worker group: a gang of train-worker actors on a placement group.

Counterpart of ``ray_tpu/train/worker_group.py``; that is, of the
reference's WorkerGroup (Ray's python/ray/train/v2/_internal/execution/
worker_group/worker_group.py:105, PG at :242, per-rank bundles at :364)
with the thread runner (thread_runner.py) folded into the worker actor.
Each ``TrainWorker`` is an actor of the port's runtime pinned to its
rank's bundle of one placement group (``ScalingConfig.bundle()``:
``{"CPU": 1, "GPU": 1}`` on the card, ``{"CPU": 1}`` with
``use_gpu=False``).  Its ``setup`` joins the ranks' ``torch.distributed``
process group inside the actor, with an explicit ``tcp://<addr>:<port>``
address (by default this host's peer-routable address and a free port,
as the JAX package's ``TorchConfig`` picks them), the world size and the
rank (NCCL on the GPUs, gloo on the CPU, unless the group is given
another backend), and sets the variables a torch program reads (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).  Under its
grant an actor sees only its own card, so a worker's device is
``cuda:0`` within it.  The train function crosses to the actors by
cloudpickle and runs on a thread of each; the controller polls their
reports.
"""

from __future__ import annotations

import datetime
import os
import socket
import threading
import traceback
from typing import Any, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.train import context as train_context
from ray_tpu_torch.train.config import ScalingConfig

SETUP_TIMEOUT_S = 300.0  # start the actors, import torch, join the group
POLL_TIMEOUT_S = 120.0
SHUTDOWN_TIMEOUT_S = 5.0  # then the actors are killed


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _default_master_addr() -> str:
    """A peer-routable address for this host (loopback only as a last
    resort: 127.0.0.1 can never bring together ranks on two hosts).  The
    UDP ``connect`` sends nothing; it asks the kernel which interface
    routes outward."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


class TrainWorker:
    """Actor hosting one rank: runs the user's train fn on a thread."""

    def __init__(self):
        self._ctx: Optional[train_context.TrainContext] = None
        self._thread: Optional[threading.Thread] = None
        self._done = False
        self._error: Optional[str] = None

    def setup(self, rank: int, local_rank: int, world_size: int,
              experiment_name: str, experiment_dir: str,
              restore_checkpoint_path: Optional[str], address: str,
              backend: str, timeout_s: float, device: str,
              dataset_shards_blob: Optional[bytes],
              trial_info: Optional[dict] = None,
              start_report_index: int = 0) -> bool:
        """Join the process group at ``address`` and build the rank's
        ``TrainContext``."""
        import torch
        import torch.distributed as dist

        shards = (cloudpickle.loads(dataset_shards_blob)
                  if dataset_shards_blob else None)
        if device.startswith("cuda"):
            torch.cuda.set_device(device)
        host, port = address.removeprefix("tcp://").rsplit(":", 1)
        os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=str(rank),
                          WORLD_SIZE=str(world_size),
                          LOCAL_RANK=str(local_rank))
        dist.init_process_group(
            backend, init_method=address, world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
            **({"device_id": torch.device(device)} if backend == "nccl"
               else {}))
        self._ctx = train_context.TrainContext(
            rank=rank, local_rank=local_rank, world_size=world_size,
            experiment_name=experiment_name, experiment_dir=experiment_dir,
            restore_checkpoint_path=restore_checkpoint_path,
            dataset_shards=shards, trial_info=trial_info,
            start_report_index=start_report_index, device=device)
        return True

    def run(self, fn_blob: bytes, config: Optional[dict]) -> bool:
        fn = cloudpickle.loads(fn_blob)
        ctx = self._ctx

        def target():
            import torch

            if ctx.device.startswith("cuda"):
                torch.cuda.set_device(ctx.device)  # per thread
            train_context._set_context(ctx)
            try:
                if config is not None:
                    fn(config)
                else:
                    fn()
            except train_context._StopTraining:
                pass
            except BaseException:
                self._error = traceback.format_exc()
            finally:
                self._done = True
                train_context._set_context(None)

        self._done = False
        self._error = None
        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        return True

    def poll(self) -> dict:
        # Snapshot done/error BEFORE draining: report() enqueues
        # happen-before _done=True, so done-then-drain can never lose the
        # final report.
        done, error = self._done, self._error
        reports = []
        ctx = self._ctx
        if ctx is not None:
            while not ctx.outbox.empty():
                reports.append(ctx.outbox.get_nowait())
        return {"reports": reports, "done": done, "error": error}

    def stop(self) -> bool:
        if self._ctx is not None:
            self._ctx.stop_event.set()
        return True

    def shutdown(self) -> bool:
        """Leave the process group (the actor is killed after)."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        return True


class WorkerGroup:
    """Creates/destroys the gang; fans calls out to all ranks.  The
    process group takes ``backend`` (default: the scaling config's) and
    ``timeout_s`` for its collectives, and forms at ``master_addr``
    (default: ``_default_master_addr()``) and ``master_port`` (default: a
    free port, chosen at each ``start``)."""

    def __init__(self, scaling_config: ScalingConfig,
                 num_workers: Optional[int] = None,
                 backend: Optional[str] = None,
                 timeout_s: float = SETUP_TIMEOUT_S,
                 master_addr: Optional[str] = None,
                 master_port: Optional[int] = None):
        """num_workers overrides the config's size: the controller's
        elastic policy passes the per-attempt world size here."""
        self._config = scaling_config
        self._num_workers = num_workers or scaling_config.num_workers
        self._backend = backend or scaling_config.backend
        self._timeout_s = timeout_s
        self._master_addr = master_addr
        self._master_port = master_port
        self._pg = None
        self._workers: list[Any] = []

    @property
    def workers(self):
        return self._workers

    @property
    def num_workers(self) -> int:
        return self._num_workers

    def start(self, experiment_name: str, experiment_dir: str,
              restore_checkpoint_path: Optional[str] = None,
              dataset_shards_per_rank: Optional[list] = None,
              trial_info: Optional[dict] = None,
              start_report_index: int = 0):
        """Reserve the bundles, start one actor in each and wait until
        every rank has joined the process group.  Raises
        ``PlacementGroupUnavailableError`` where the bundles cannot be
        reserved now."""
        from ray_tpu_torch.util.placement_group import placement_group
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
        )

        cfg = self._config
        n = self._num_workers
        bundle = cfg.bundle()
        self._pg = placement_group(
            [dict(bundle) for _ in range(n)],
            strategy=cfg.placement_strategy)
        actor_cls = ray_tpu_torch.remote(TrainWorker)
        self._workers = []
        for rank in range(n):
            strategy = PlacementGroupSchedulingStrategy(
                self._pg, placement_group_bundle_index=rank)
            opts = {"scheduling_strategy": strategy,
                    "num_cpus": bundle.get("CPU", 0),
                    "num_gpus": bundle.get("GPU", 0)}
            others = {k: v for k, v in bundle.items()
                      if k not in ("CPU", "GPU")}
            if others:
                opts["resources"] = others
            self._workers.append(actor_cls.options(**opts).remote())

        address = (f"tcp://{self._master_addr or _default_master_addr()}:"
                   f"{self._master_port or _free_port()}")
        setups = []
        for rank, w in enumerate(self._workers):
            shards = None
            if dataset_shards_per_rank is not None:
                # through the store, not inline in the call: the native
                # transport drops a connection whose peer reads nothing for
                # 10 s (core_worker.cc send_all), and a new worker importing
                # torch and making its CUDA context reads nothing for about
                # that long, so a call frame larger than the socket's buffer
                # sent meanwhile killed the actor (1.3 MB of token rows did,
                # 5 runs of 6 on the H100's host); the worker gets the bytes
                # from the store once it runs ``setup``
                shards = ray_tpu_torch.put(cloudpickle.dumps(
                    dataset_shards_per_rank[rank]))
            setups.append(w.setup.remote(
                rank, rank, n, experiment_name, experiment_dir,
                restore_checkpoint_path, address, self._backend,
                self._timeout_s, cfg.device, shards, trial_info,
                start_report_index))
        ray_tpu_torch.get(setups, timeout=SETUP_TIMEOUT_S)

    def run(self, train_fn, config: Optional[dict]):
        blob = cloudpickle.dumps(train_fn)
        ray_tpu_torch.get([w.run.remote(blob, config) for w in self._workers],
                          timeout=POLL_TIMEOUT_S)

    def poll(self) -> list[dict]:
        return ray_tpu_torch.get([w.poll.remote() for w in self._workers],
                                 timeout=POLL_TIMEOUT_S)

    def stop(self):
        try:
            ray_tpu_torch.get([w.stop.remote() for w in self._workers],
                              timeout=SHUTDOWN_TIMEOUT_S)
        except Exception:
            pass

    def shutdown(self, graceful: bool = True):
        if graceful and self._workers:
            try:
                ray_tpu_torch.get(
                    [w.shutdown.remote() for w in self._workers],
                    timeout=SHUTDOWN_TIMEOUT_S)
            except Exception:
                pass
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self._workers = []
        if self._pg is not None:
            from ray_tpu_torch.util.placement_group import (
                remove_placement_group,
            )
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None
