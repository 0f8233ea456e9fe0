"""In-process multi-node cluster for tests and local experimentation.

Counterpart of ``ray_tpu/cluster_utils.py``, less its
``AutoscalingCluster`` (the port has no autoscaler yet); that is, of the
reference's test workhorse (Ray's python/ray/cluster_utils.py:135
``Cluster``): a head node (GCS service + scheduler + store) plus N worker
nodes, each with its OWN object store (separate shm segment) and worker
pool, joined through the head's GCS address.  Two node flavors:

- in-process (default): node services run as threads in the calling
  process — workers are real subprocesses either way.
- external (``add_node(external=True)``): the whole node runs as a
  SEPARATE OS PROCESS (ray_tpu_torch._private.node_main) joined over TCP —
  the same process/transport topology a multi-host deployment has
  (reference: ray start-launched raylet processes).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional, Union

from ray_tpu_torch._private.node import Node


class ExternalNode:
    """Handle to a node running as its own OS process (node_main)."""

    def __init__(self, proc: subprocess.Popen, info: dict):
        self.proc = proc
        self.node_id = bytes.fromhex(info["node_id"])
        self.gcs_address = info["gcs_address"]
        self.sched_address = info["sched_address"]
        self.session_dir = info["session_dir"]

    def shutdown(self, timeout: float = 10.0):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()

    def kill(self):
        """Hard-kill the node process (crash simulation — no cleanup)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None):
        self.head_node: Optional[Node] = None
        self.worker_nodes: list[Union[Node, ExternalNode]] = []
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def gcs_address(self) -> str:
        return self.head_node.gcs_address

    def add_node(self, external: bool = False, **node_args) -> Union[
            Node, ExternalNode]:
        """Start one more node; the first becomes the head.

        external=True launches the node as a separate OS process over TCP
        (requires the head to listen on TCP too: pass
        head_node_args={"listen_host": "127.0.0.1"}).
        """
        if external:
            if self.head_node is None:
                raise ValueError("start the head in-process first "
                                 "(head drives the test)")
            node = self._spawn_external(**node_args)
            self.worker_nodes.append(node)
            return node
        if self.head_node is None:
            node = Node(head=True, **node_args)
            self.head_node = node
        else:
            node = Node(head=False, gcs_address=self.gcs_address,
                        **node_args)
            self.worker_nodes.append(node)
        return node

    def _spawn_external(self, resources: Optional[dict] = None,
                        min_workers: int = 1,
                        max_workers: Optional[int] = None,
                        object_store_memory: Optional[int] = None,
                        listen_host: Optional[str] = None,
                        **unsupported) -> ExternalNode:
        if unsupported:
            raise TypeError(
                f"external nodes do not support node args "
                f"{sorted(unsupported)}")
        ready = tempfile.mktemp(prefix="rtpu_node_ready_")
        host = listen_host or self.head_node.listen_host or "127.0.0.1"
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.node_main",
               "--address", self.gcs_address,
               "--listen-host", host,
               "--min-workers", str(min_workers),
               "--ready-file", ready]
        if max_workers is not None:
            cmd += ["--max-workers", str(max_workers)]
        if object_store_memory is not None:
            cmd += ["--object-store-memory", str(object_store_memory)]
        if resources:
            cmd += ["--resources", json.dumps(resources)]
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(cmd, env=env)
        deadline = time.monotonic() + 60.0
        while not os.path.exists(ready):
            if proc.poll() is not None:
                raise RuntimeError(
                    f"external node exited rc={proc.returncode} at startup")
            if time.monotonic() > deadline:
                proc.kill()
                raise TimeoutError("external node did not come up in 60s")
            time.sleep(0.05)
        with open(ready) as f:
            info = json.load(f)
        os.unlink(ready)
        return ExternalNode(proc, info)

    def remove_node(self, node: Union[Node, ExternalNode],
                    allow_graceful: bool = True):
        """Stop a node and broadcast its death (reference:
        Cluster.remove_node kills the raylet; GCS health checks notice).

        allow_graceful=False skips the immediate GCS notification so death
        is discovered by heartbeat timeout — the crash-like path."""
        if node is self.head_node:
            raise ValueError("removing the head node tears down the "
                             "cluster; use shutdown()")
        if node in self.worker_nodes:
            self.worker_nodes.remove(node)
        if isinstance(node, ExternalNode):
            if allow_graceful:
                node.shutdown()
            else:
                node.kill()
        else:
            node.shutdown()
        if allow_graceful and self.head_node is not None:
            self.head_node.gcs.mark_node_dead(node.node_id)

    def wait_for_nodes(self, timeout: float = 30.0) -> int:
        """Block until every added node is alive in the GCS; returns the
        live count."""
        want = 1 + len(self.worker_nodes)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = len([n for n in self.head_node.gcs.list_nodes()
                         if n.alive])
            if alive >= want:
                return alive
            time.sleep(0.05)
        raise TimeoutError(
            f"only {alive}/{want} nodes alive after {timeout}s")

    def shutdown(self):
        for node in self.worker_nodes:
            node.shutdown()
        self.worker_nodes = []
        if self.head_node is not None:
            self.head_node.shutdown()
            self.head_node = None
