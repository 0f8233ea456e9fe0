"""Job submission SDK.

Counterpart of Ray's python/ray/job_submission/ (JobSubmissionClient
over the dashboard REST API; here the transport is the head scheduler's
control socket — same one-shot framed-pickle protocol as the state API).
"""

from __future__ import annotations

import time
from typing import Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.job_manager import JobInfo, JobStatus

__all__ = ["JobSubmissionClient", "JobStatus", "JobInfo"]


def _rpc(sock: str, method: str, params: Optional[dict] = None):
    conn = protocol.connect_addr(sock)
    try:
        conn.send({"t": "rpc", "method": method, "params": params or {}})
        resp = conn.recv()
    finally:
        conn.close()
    if resp is None or not resp.get("ok"):
        raise RuntimeError(f"job rpc {method} failed: "
                           f"{resp.get('error') if resp else 'closed'}")
    return resp["result"]


class _RpcCtx:
    """ctx.rpc adapter so runtime_env packaging can upload to the GCS KV."""

    def __init__(self, sock: str):
        self._sock = sock

    def rpc(self, method: str, params: dict):
        return _rpc(self._sock, method, params)


def _find_head_socket(address: Optional[str]) -> str:
    """Resolve the HEAD node's scheduler socket (job RPCs are head-only)
    from ``address``, or else from the live sessions under the port's
    ``session_root()``, newest first."""
    from ray_tpu_torch._private.node import live_session_sockets

    candidates = [address] if address else live_session_sockets()
    for sock in candidates:
        try:
            for n in _rpc(sock, "list_nodes"):
                if n["is_head"] and n["alive"]:
                    return n["sched_socket"]
        except Exception:
            continue
    raise ConnectionError(
        "could not find a live head node; is a cluster running? "
        "(pass address=<sched.sock of any node>)")


class JobSubmissionClient:
    def __init__(self, address: Optional[str] = None):
        self._sock = _find_head_socket(address)

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   submission_id: Optional[str] = None,
                   metadata: Optional[dict] = None) -> str:
        from ray_tpu_torch._private.runtime_env import package
        packaged = package(runtime_env, _RpcCtx(self._sock))
        return _rpc(self._sock, "job_submit", {
            "entrypoint": entrypoint,
            "runtime_env": packaged,
            "submission_id": submission_id,
            "metadata": metadata,
        })

    def get_job_status(self, submission_id: str) -> str:
        info = _rpc(self._sock, "job_status",
                    {"submission_id": submission_id})
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        return info["status"]

    def get_job_info(self, submission_id: str) -> JobInfo:
        info = _rpc(self._sock, "job_status",
                    {"submission_id": submission_id})
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        return JobInfo(**info)

    def list_jobs(self) -> list[JobInfo]:
        return [JobInfo(**row) for row in _rpc(self._sock, "job_list")]

    def get_job_logs(self, submission_id: str) -> str:
        return _rpc(self._sock, "job_logs",
                    {"submission_id": submission_id})

    def stop_job(self, submission_id: str) -> bool:
        return _rpc(self._sock, "job_stop",
                    {"submission_id": submission_id})

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(0.25)
        raise TimeoutError(
            f"job {submission_id} not finished after {timeout}s")
