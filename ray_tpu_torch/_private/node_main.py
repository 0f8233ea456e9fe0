"""Standalone node process: one cluster node as its own OS process.

Counterpart of the reference's `ray start` node processes
(Ray's python/ray/_private/node.py start_head_processes /
start_ray_processes spawning gcs_server + raylet as separate processes,
services.py:1442,1526): runs a head or worker Node until SIGTERM/SIGINT,
optionally announcing its addresses through a ready-file so a parent
process (cluster_utils.Cluster, the autoscaler's local provider, tests)
can attach without scraping stdout.

    python -m ray_tpu_torch._private.node_main --head --listen-host 127.0.0.1 \
        --ready-file /tmp/head.json
    python -m ray_tpu_torch._private.node_main --address 127.0.0.1:6379 \
        --listen-host 127.0.0.1 --resources '{"CPU": 4}'
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", default=None,
                   help="head's GCS address (worker nodes)")
    p.add_argument("--listen-host", default=None,
                   help="bind control plane to TCP on this interface")
    p.add_argument("--resources", default=None, help="JSON resource dict")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    p.add_argument("--min-workers", type=int, default=None)
    p.add_argument("--max-workers", type=int, default=None)
    p.add_argument("--object-store-memory", type=int, default=None)
    p.add_argument("--node-id", default=None, help="hex node id")
    p.add_argument("--session-dir", default=None)
    p.add_argument("--gcs-persist-path", default=None,
                   help="head only: persist GCS tables here; a restarted "
                        "head restores actors/PGs/KV from it")
    p.add_argument("--ready-file", default=None,
                   help="write {gcs_address, sched_address, node_id} JSON "
                        "here once the node is serving")
    p.add_argument("--exact-resources", action="store_true",
                   help="advertise exactly --resources (no host detection)")
    args = p.parse_args()

    from ray_tpu_torch._private.node import Node

    res = {}
    if args.resources:
        res.update({k: float(v)
                    for k, v in json.loads(args.resources).items()})
    if args.num_cpus is not None:
        res["CPU"] = args.num_cpus
    if args.num_gpus is not None:
        res["GPU"] = args.num_gpus

    if not args.head and args.address is None:
        p.error("worker nodes need --address (the head's GCS address)")
    node = Node(
        head=args.head,
        gcs_address=args.address,
        resources=res or None,
        object_store_memory=args.object_store_memory,
        min_workers=(args.min_workers if args.min_workers is not None
                     else (2 if args.head else 1)),
        max_workers=args.max_workers,
        node_id=bytes.fromhex(args.node_id) if args.node_id else None,
        session_dir=args.session_dir,
        listen_host=args.listen_host,
        gcs_persist_path=args.gcs_persist_path,
        include_dashboard=False,
        merge_default_resources=not args.exact_resources,
    )
    # `rtpu stop` parity: standalone nodes accept external shutdown RPCs.
    node.scheduler.allow_external_shutdown = True

    info = {"gcs_address": node.gcs_address,
            "sched_address": node.sched_address,
            "node_id": node.node_id.hex(),
            "session_dir": node.session_dir,
            "pid": os.getpid()}
    if args.ready_file:
        tmp = args.ready_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(info, f)
        os.replace(tmp, args.ready_file)  # atomic: readers never see partial
    print("node ready: " + json.dumps(info), flush=True)

    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    stop.wait()
    node.shutdown()
    sys.exit(0)


if __name__ == "__main__":
    main()
