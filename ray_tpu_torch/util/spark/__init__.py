"""Ray-on-Spark: launch the port's cluster across a Spark cluster's workers.

Counterpart of ``ray_tpu/util/spark/__init__.py``, that is, of Ray's
python/ray/util/spark/cluster_init.py (``setup_ray_cluster`` /
``shutdown_ray_cluster``).  Ray starts one ``ray start`` worker per Spark
task slot inside a barrier-mode Spark job and wires them to a head on the
Spark driver; this does the same with the port's ``rtpu start``
(``ray_tpu_torch/scripts/cli.py``) as the per-slot command.

pyspark is in neither image the port runs in, so the Spark-job half is
gated on import: the command construction (what each executor runs) is
factored out and unit-tested, and ``setup_ray_cluster`` raises a clear
ImportError without pyspark.
"""

from __future__ import annotations

import shlex
import sys
from typing import List, Optional

_active: dict = {}


def _worker_start_command(head_address: str, *, num_cpus: int,
                          extra_resources: Optional[dict] = None
                          ) -> List[str]:
    """The per-Spark-task-slot node launch command (Ray's
    cluster_init.py's ray-start arg assembly, on `rtpu start` flags)."""
    cmd = [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "start",
           "--address", head_address, "--num-cpus", str(num_cpus)]
    if extra_resources:
        import json

        cmd += ["--resources", json.dumps(extra_resources)]
    return cmd


def setup_ray_cluster(num_worker_nodes: int, *, num_cpus_per_node: int = 1,
                      **kwargs) -> str:
    """Start the port's cluster on the active Spark cluster.  Returns the
    head address.  Requires pyspark with an active SparkSession."""
    try:
        import pyspark  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "setup_ray_cluster requires pyspark (not present in this "
            "image).  On a Spark cluster: pip install pyspark, then each "
            "Spark task slot runs: "
            + shlex.join(_worker_start_command("<head>:port",
                                               num_cpus=num_cpus_per_node))
        ) from e
    from pyspark.sql import SparkSession

    spark = SparkSession.getActiveSession()
    if spark is None:
        raise RuntimeError("no active SparkSession")
    import ray_tpu_torch

    ray_tpu_torch.init()
    import ray_tpu_torch.api as api

    head_address = api._global_node.gcs_address
    cmds = [_worker_start_command(head_address,
                                  num_cpus=num_cpus_per_node)
            for _ in range(num_worker_nodes)]

    def _launch(it):
        import subprocess

        for cmd in it:
            subprocess.Popen(cmd)
        yield 0

    rdd = spark.sparkContext.parallelize(cmds, num_worker_nodes)
    rdd.barrier().mapPartitions(_launch).collect()
    _active["head"] = head_address
    return head_address


def _stop_worker_nodes() -> int:
    """Send shutdown_node to every alive non-head node (the `rtpu stop`
    path: only standalone `rtpu start` processes honor it — exactly what
    setup_ray_cluster launched on the executors).  Returns nodes asked."""
    import ray_tpu_torch.api as api
    from ray_tpu_torch._private import protocol

    if api._global_node is None:
        return 0
    n = 0
    for node in api._global_node.gcs.list_nodes():
        if not node.alive or node.is_head:
            continue
        try:
            conn = protocol.connect_addr(node.sched_socket)
            try:
                conn.send({"t": "rpc", "method": "shutdown_node",
                           "params": {}})
                conn.recv()
            finally:
                conn.close()
            n += 1
        except Exception:
            continue  # best-effort: a dead executor already took it down
    return n


def shutdown_ray_cluster() -> None:
    if not _active:
        return
    import ray_tpu_torch

    _stop_worker_nodes()  # reap the Popen'd per-slot worker daemons
    ray_tpu_torch.shutdown()
    _active.clear()


__all__ = ["setup_ray_cluster", "shutdown_ray_cluster"]
