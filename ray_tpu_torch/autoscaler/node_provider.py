"""Node providers: pluggable machine lifecycle for the autoscaler.

Counterpart of ``ray_tpu/autoscaler/node_provider.py`` (Ray's
python/ray/autoscaler/node_provider.py, the NodeProvider plugin interface
implemented by aws/gcp/azure/... providers, and the fake multi-node
provider Ray tests autoscaling with,
_private/fake_multi_node/node_provider.py): ``create_node(node_type)``
launches one machine of a configured type, which joins the cluster
through the head's GCS address.  A GPU node type declares its cards
(``{"GPU": 1}``): the launched node advertises exactly that shape.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List


def launch_node_process(gcs_address: str, resources: Dict[str, float],
                        node_id: bytes) -> subprocess.Popen:
    """``rtpu start`` as a node of exactly ``resources`` (``--resources``
    is the CLI's exact mode) joining ``gcs_address`` as ``node_id``, with
    this checkout on ``PYTHONPATH``, in a session of its own: its process
    group holds the node, its workers and its store daemon."""
    import json

    args = [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "start",
            "--address", gcs_address,
            "--node-id", node_id.hex(), "--min-workers", "1",
            "--resources", json.dumps(resources)]
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        args, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True)


def _group_running(pgid: int) -> bool:
    """Whether a process of group ``pgid`` runs (zombies left to a parent
    that does not reap do not count)."""
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            return True
    return False


def stop_node_process(proc: subprocess.Popen, node_id: bytes,
                      timeout: float = 5.0) -> None:
    """Stop a node started with ``start_new_session`` and wait until it
    and its process group (workers, store daemon) are gone: SIGTERM the
    group, wait for the node process, wait for the rest of the group and
    SIGKILL what outlives ``timeout``, then unlink the node's shm segment
    if the node could not (a node signalled while it starts dies before
    its handler is installed).  The JAX package's v1 provider SIGTERMs the
    group and waits for the node process only."""
    from ray_tpu_torch._private.node import SHM_PREFIX

    deadline = time.monotonic() + timeout
    try:
        os.killpg(proc.pid, signal.SIGTERM)
    except ProcessLookupError:
        pass
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    while time.monotonic() < deadline:
        if not _group_running(proc.pid):
            break
        time.sleep(0.05)
    else:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()
    try:
        os.unlink(f"/dev/shm/{SHM_PREFIX}{proc.pid}_{node_id[:4].hex()}")
    except OSError:
        pass


class NodeProvider:
    """Implement create/terminate/list for one deployment substrate."""

    def create_node(self, node_type: str, resources: Dict[str, float],
                    node_id: bytes) -> None:
        raise NotImplementedError

    def terminate_node(self, node_id: bytes) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[bytes]:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class FakeNodeProvider(NodeProvider):
    """Launches real worker-node PROCESSES on this machine (Ray's
    fake_multi_node provider does the same with docker/processes): every
    scaling decision exercises true node bootstrap, GCS join, scheduling
    spillback, and node-death handling.  Nodes start through
    ``launch_node_process`` and stop through ``stop_node_process``."""

    def __init__(self, gcs_address: str):
        self._gcs_address = gcs_address
        self._procs: Dict[bytes, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def create_node(self, node_type: str, resources: Dict[str, float],
                    node_id: bytes) -> None:
        proc = launch_node_process(self._gcs_address, resources, node_id)
        with self._lock:
            self._procs[node_id] = proc

    def terminate_node(self, node_id: bytes) -> None:
        with self._lock:
            proc = self._procs.pop(node_id, None)
        if proc is not None:
            stop_node_process(proc, node_id)

    def non_terminated_nodes(self) -> List[bytes]:
        with self._lock:
            return [nid for nid, p in self._procs.items()
                    if p.poll() is None]

    def shutdown(self) -> None:
        with self._lock:
            ids = list(self._procs)
        for nid in ids:
            self.terminate_node(nid)
