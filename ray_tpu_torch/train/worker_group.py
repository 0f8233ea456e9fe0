"""Worker group: one local process per worker, joined by torch.distributed.

Counterpart of ``ray_tpu/train/worker_group.py``.  The JAX package's
workers are actors of its runtime, one per host, each driving every local
chip through one SPMD program.  The port has no actor runtime and follows
torch's idiom of one process per GPU: each ``TrainWorker`` is a process
started with ``multiprocessing``'s spawn context, and the group's ranks
form one process group (``init_process_group`` with an explicit
``tcp://127.0.0.1:<free port>`` address, the world size and the rank;
NCCL on the GPUs, gloo on the CPU, unless the group is given another
backend).  Each worker also sets the variables a torch program reads
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``).  The train function and its config cross to the workers
by pickling, so the function is a module-level one.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Callable, Optional

from ray_tpu_torch.train.config import ScalingConfig

SETUP_TIMEOUT_S = 300.0  # spawn, import torch, join the process group
SHUTDOWN_TIMEOUT_S = 10.0  # then the process is killed


class WorkerGroupError(RuntimeError):
    """A worker could not be started or reached."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_main(rank: int, local_rank: int, world_size: int, address: str,
                 scaling: ScalingConfig, backend: str, timeout_s: float,
                 setup: dict, inbox, outbox, stop_event) -> None:
    """One worker process: join the group, run the train function it is
    sent, report its end, and leave the group when told to shut down."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train import context as train_context

    device = scaling.device(local_rank)
    if scaling.use_gpu:
        torch.cuda.set_device(local_rank)
    host, port = address.removeprefix("tcp://").rsplit(":", 1)
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(world_size), LOCAL_RANK=str(local_rank))
    dist.init_process_group(
        backend, init_method=address, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
        **({"device_id": torch.device(device)} if backend == "nccl" else {}))
    ctx = train_context.TrainContext(
        rank=rank, local_rank=local_rank, world_size=world_size,
        outbox=outbox, stop_event=stop_event, device=device, **setup)
    outbox.put({"status": "ready", "rank": rank})
    try:
        while True:
            msg = inbox.get()
            if msg[0] == "shutdown":
                return
            _, fn, config = msg
            train_context._set_context(ctx)
            error = None
            try:
                fn(config) if config is not None else fn()
            except train_context._StopTraining:
                pass
            except BaseException:
                error = traceback.format_exc()
            finally:
                train_context._set_context(None)
            outbox.put({"status": "done", "rank": rank, "error": error})
    finally:
        dist.destroy_process_group()


class TrainWorker:
    """The controller's handle on one worker process."""

    def __init__(self, rank: int, world_size: int, scaling: ScalingConfig,
                 backend: Optional[str] = None,
                 timeout_s: float = SETUP_TIMEOUT_S):
        self.rank, self.world_size = rank, world_size
        self._scaling = scaling
        self._backend = backend or scaling.backend
        self._timeout_s = timeout_s
        self._ctx = multiprocessing.get_context("spawn")
        self._inbox = self._ctx.Queue()
        self._outbox = self._ctx.Queue()
        self._stop = self._ctx.Event()
        self._proc = None
        self._ready = self._done = False
        self._error: Optional[str] = None

    def setup(self, address: str, setup: dict) -> None:
        """Start the process; it joins the process group at ``address``
        (``setup`` holds the ``TrainContext`` fields)."""
        self._proc = self._ctx.Process(
            target=_worker_main, daemon=True,
            args=(self.rank, self.rank, self.world_size, address,
                  self._scaling, self._backend, self._timeout_s, setup,
                  self._inbox, self._outbox, self._stop))
        self._proc.start()

    def run(self, fn: Callable, config: Optional[dict]) -> None:
        self._done, self._error = False, None
        self._inbox.put(("run", fn, config))

    def poll(self) -> dict:
        """Reports since the last poll, whether the train function ended,
        and its traceback if it raised (or the process's end if it died)."""
        reports = []
        while True:
            try:
                msg = self._outbox.get_nowait()
            except queue.Empty:
                break
            if msg.get("status") == "ready":
                self._ready = True
            elif msg.get("status") == "done":
                self._done, self._error = True, msg["error"]
            else:
                reports.append(msg)
        if not self._done and self._proc is not None \
                and not self._proc.is_alive():
            self._done = True
            self._error = (f"worker {self.rank} exited with code "
                           f"{self._proc.exitcode}")
        return {"reports": reports, "done": self._done, "error": self._error,
                "ready": self._ready}

    def stop(self) -> None:
        """Unwind the train function at its next ``report``."""
        self._stop.set()

    def shutdown(self) -> None:
        """Leave the process group and end the process; one that does not
        end within ``SHUTDOWN_TIMEOUT_S`` is killed."""
        if self._proc is None:
            return
        self._inbox.put(("shutdown",))
        deadline = time.monotonic() + SHUTDOWN_TIMEOUT_S
        while self._proc.is_alive() and time.monotonic() < deadline:
            self.poll()  # drain before joining
            self._proc.join(0.1)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(SHUTDOWN_TIMEOUT_S)
        self._proc = None


class WorkerGroup:
    """Creates/destroys the gang; fans calls out to all ranks.  The
    process group takes ``backend`` (default: the scaling config's) and
    ``timeout_s`` for its collectives."""

    def __init__(self, scaling_config: ScalingConfig,
                 backend: Optional[str] = None,
                 timeout_s: float = SETUP_TIMEOUT_S):
        self._config = scaling_config
        self._backend, self._timeout_s = backend, timeout_s
        self._num_workers = scaling_config.num_workers
        self._workers: list[TrainWorker] = []

    @property
    def workers(self):
        return self._workers

    @property
    def num_workers(self) -> int:
        return self._num_workers

    def start(self, experiment_name: str, experiment_dir: str,
              restore_checkpoint_path: Optional[str] = None,
              dataset_shards_per_rank: Optional[list] = None,
              start_report_index: int = 0):
        """Start every worker and wait until all have joined the process
        group.  Raises ``WorkerGroupError`` if one dies or the group does
        not form within ``SETUP_TIMEOUT_S``."""
        import torch

        n = self._num_workers
        if self._config.use_gpu and n > torch.cuda.device_count():
            raise WorkerGroupError(
                f"{n} workers need {n} GPUs; {torch.cuda.device_count()} "
                "visible (ScalingConfig(use_gpu=False) runs on the CPU)")
        address = f"tcp://127.0.0.1:{_free_port()}"
        self._workers = [TrainWorker(r, n, self._config, self._backend,
                                     self._timeout_s) for r in range(n)]
        for rank, w in enumerate(self._workers):
            w.setup(address, {
                "experiment_name": experiment_name,
                "experiment_dir": experiment_dir,
                "restore_checkpoint_path": restore_checkpoint_path,
                "dataset_shards": (dataset_shards_per_rank[rank]
                                   if dataset_shards_per_rank else None),
                "start_report_index": start_report_index})
        deadline = time.monotonic() + SETUP_TIMEOUT_S
        while True:
            polls = [w.poll() for w in self._workers]
            dead = [p["error"] for p in polls if p["error"]]
            if dead:
                raise WorkerGroupError(dead[0])
            if all(p["ready"] for p in polls):
                return
            if time.monotonic() > deadline:
                raise WorkerGroupError(
                    f"the worker group did not form in {SETUP_TIMEOUT_S} s")
            time.sleep(0.05)

    def run(self, train_fn: Callable, config: Optional[dict]):
        for w in self._workers:
            w.run(train_fn, config)

    def poll(self) -> list[dict]:
        return [w.poll() for w in self._workers]

    def stop(self):
        for w in self._workers:
            w.stop()

    def shutdown(self):
        for w in self._workers:
            w.shutdown()
        self._workers = []
