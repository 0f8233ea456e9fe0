"""Job manager: run driver scripts as supervised subprocesses on the head.

Counterpart of the reference's job submission stack
(Ray's python/ray/dashboard/modules/job/job_manager.py:60
JobManager, job_supervisor.py:55 JobSupervisor): each submitted job is an
entrypoint shell command spawned with ``RAY_TPU_ADDRESS`` pointing at this
cluster, its runtime_env materialized (env_vars, working_dir cwd, py_modules
on PYTHONPATH), stdout+stderr tee'd to a per-job log file, and its status
FSM (PENDING→RUNNING→SUCCEEDED/FAILED/STOPPED) persisted in the GCS KV so
any client can poll it.
"""

from __future__ import annotations

import os

import signal
import subprocess
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Optional

from ray_tpu_torch._private import runtime_env as runtime_env_mod




class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"

    TERMINAL = (STOPPED, SUCCEEDED, FAILED)


@dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    message: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    metadata: dict = field(default_factory=dict)
    runtime_env: dict = field(default_factory=dict)
    log_path: str = ""

    def to_dict(self) -> dict:
        return asdict(self)


class _KvCtx:
    """Adapter giving runtime_env materialization the ctx.rpc surface."""

    def __init__(self, gcs):
        self._gcs = gcs

    def rpc(self, method: str, params: dict):
        if method == "kv_get":
            return self._gcs.kv_get(params["namespace"], params["key"])
        if method == "kv_put":
            self._gcs.kv_put(params["namespace"], params["key"],
                             params["value"])
            return True
        raise RuntimeError(f"unsupported kv rpc {method}")


class JobManager:
    def __init__(self, gcs, gcs_address: str, session_dir: str):
        self._gcs = gcs
        self._gcs_address = gcs_address
        self._log_dir = os.path.join(session_dir, "logs")
        os.makedirs(self._log_dir, exist_ok=True)
        self._procs: dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    # -- GCS job table (first-class, not KV: the daemon owns the record
    # and it survives a head restart — reference:
    # gcs_service.proto JobInfoGcsService:68) -----------------------------
    def _save(self, info: JobInfo):
        # add_job is insert-or-replace and _save always writes the full
        # record, so one unconditional call — no probe round trip
        self._gcs.add_job(info.submission_id, info.to_dict())

    def _load(self, submission_id: str) -> Optional[dict]:
        return self._gcs.get_job(submission_id)

    def reconcile(self):
        """Head (re)start: restored jobs whose supervisor died with the
        previous head process can never finish — record the truth."""
        for row in self._gcs.list_jobs():
            if row.get("status") in (JobStatus.PENDING, JobStatus.RUNNING):
                sid = row.get("submission_id")
                with self._lock:
                    if sid in self._procs:
                        continue  # this incarnation supervises it
                self._gcs.update_job(sid, {
                    "status": JobStatus.FAILED,
                    "message": "head restarted; job supervisor lost",
                    "end_time": time.time()})

    # -- RPC surface -------------------------------------------------------
    def submit(self, entrypoint: str, runtime_env: Optional[dict] = None,
               submission_id: Optional[str] = None,
               metadata: Optional[dict] = None) -> str:
        sub_id = submission_id or f"rtpu-job-{uuid.uuid4().hex[:10]}"
        if self._load(sub_id) is not None:
            raise ValueError(f"job {sub_id!r} already exists")
        info = JobInfo(
            submission_id=sub_id, entrypoint=entrypoint,
            metadata=metadata or {}, runtime_env=runtime_env or {},
            log_path=os.path.join(self._log_dir, f"job-{sub_id}.log"))
        self._save(info)
        threading.Thread(target=self._supervise, args=(info,),
                         name=f"job-{sub_id}", daemon=True).start()
        return sub_id

    def status(self, submission_id: str) -> Optional[dict]:
        return self._load(submission_id)

    def list_jobs(self) -> list[dict]:
        return sorted(self._gcs.list_jobs(),
                      key=lambda r: r.get("start_time") or 0)

    def logs(self, submission_id: str) -> str:
        info = self._load(submission_id)
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        try:
            with open(info["log_path"], "r", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def stop(self, submission_id: str) -> bool:
        with self._lock:
            proc = self._procs.get(submission_id)
        if proc is None or proc.poll() is not None:
            return False
        # Record STOPPED BEFORE killing: the supervisor's wait() returns the
        # moment the process dies and must observe the terminal state (else
        # it records FAILED "exit code -15" for a deliberate stop).
        info_d = self._load(submission_id)
        if info_d is not None:
            info = JobInfo(**info_d)
            info.status = JobStatus.STOPPED
            info.message = "stopped by user"
            info.end_time = time.time()
            self._save(info)
        # Kill the whole process group: drivers spawn their own node
        # (store daemon, workers) which must die with them.
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        return True

    # -- supervisor --------------------------------------------------------
    def _supervise(self, info: JobInfo):
        env = dict(os.environ)
        env["RAY_TPU_ADDRESS"] = self._gcs_address
        # The driver must import ray_tpu_torch even when working_dir moves its
        # cwd (source-checkout deployments have no site-packages install).
        import ray_tpu_torch
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        cwd = None
        kv_ctx = _KvCtx(self._gcs)
        try:
            renv = info.runtime_env or {}
            for k, v in (renv.get("env_vars") or {}).items():
                env[k] = v
            if renv.get("working_dir"):
                cwd = runtime_env_mod._materialize(renv["working_dir"], kv_ctx)
                env["PYTHONPATH"] = cwd + os.pathsep + env.get("PYTHONPATH", "")
            for uri in renv.get("py_modules") or []:
                path = runtime_env_mod._materialize(uri, kv_ctx)
                env["PYTHONPATH"] = path + os.pathsep + env.get(
                    "PYTHONPATH", "")
            log_f = open(info.log_path, "wb", buffering=0)
            proc = subprocess.Popen(
                info.entrypoint, shell=True, cwd=cwd, env=env,
                stdout=log_f, stderr=subprocess.STDOUT,
                start_new_session=True)  # own pgid so stop() can killpg
        except BaseException as e:  # noqa: BLE001
            info.status = JobStatus.FAILED
            info.message = f"failed to start: {e!r}"
            info.end_time = time.time()
            self._save(info)
            return
        with self._lock:
            self._procs[info.submission_id] = proc
        info.status = JobStatus.RUNNING
        info.start_time = time.time()
        self._save(info)
        rc = proc.wait()
        log_f.close()
        latest = self._load(info.submission_id)
        if latest and latest["status"] == JobStatus.STOPPED:
            return  # stop() already recorded the terminal state
        info.status = JobStatus.SUCCEEDED if rc == 0 else JobStatus.FAILED
        info.message = f"exit code {rc}"
        info.end_time = time.time()
        self._save(info)

    def shutdown(self):
        with self._lock:
            procs = list(self._procs.values())
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
