"""Public API: init/shutdown/remote/get/put/wait/kill/cancel/...

Counterpart of the reference's top-level API surface
(Ray's python/ray/_private/worker.py: init :1330, get/put/wait, and
python/ray/__init__.py re-exports).
"""

from __future__ import annotations

import atexit
import inspect
import os
import time
from typing import Optional, Sequence, Union

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.node import Node
from ray_tpu_torch._private.worker import WorkerContext, global_worker
from ray_tpu_torch.core.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction

_global_node: Optional[Node] = None


def init(
    address: Optional[str] = None,
    *,
    resources: Optional[dict] = None,
    object_store_memory: Optional[int] = None,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    min_workers: Optional[int] = None,  # default: 2 head / 0 attached
    max_workers: Optional[int] = None,
    ignore_reinit_error: bool = False,
    _existing_node: Optional["Node"] = None,
) -> "Node":
    """Start a cluster (or attach the driver to an existing head node —
    used by cluster_utils.Cluster, which owns that node's lifecycle)."""
    global _global_node
    if worker_mod.is_initialized():
        if ignore_reinit_error:
            return _global_node
        raise RuntimeError("ray_tpu_torch.init() called twice; pass "
                           "ignore_reinit_error=True to ignore")
    res = dict(resources or {})
    if num_cpus is not None:
        res["CPU"] = float(num_cpus)
    if num_gpus is not None:
        res["GPU"] = float(num_gpus)
    address = address or os.environ.get("RAY_TPU_ADDRESS")
    if address is not None and address.startswith("rtpu://"):
        # Remote-driver client mode (reference: ray://): no local node at
        # all — every operation proxies over TCP (util/client).
        from ray_tpu_torch.util.client import connect_client

        ctx = connect_client(address)
        worker_mod.set_global_worker(ctx)
        atexit.register(shutdown)
        return None
    if address is not None:
        # Attach this process to an existing cluster as a driver: start a
        # local (non-head) node joined through the head's gcs.sock
        # (reference: ray.init(address=...) connecting a driver,
        # python/ray/_private/worker.py:1330). By default the attached
        # driver contributes no resources — its tasks spill to the
        # cluster's nodes — so a transient job driver doesn't distort the
        # cluster's capacity.
        if address == "auto":
            address = _find_gcs_address()
        node = Node(
            head=False,
            gcs_address=address,
            resources=res or {"CPU": 0.0, "GPU": 0.0},
            object_store_memory=object_store_memory,
            min_workers=0 if min_workers is None else min_workers,
            max_workers=max_workers,
        )
    else:
        node = _existing_node or Node(
            resources=res or None,
            object_store_memory=object_store_memory,
            min_workers=2 if min_workers is None else min_workers,
            max_workers=max_workers,
        )
    _global_node = node
    _attach_driver(node)
    if _existing_node is None:
        atexit.register(shutdown)
    return node


def _find_gcs_address() -> str:
    """Newest LIVE session's gcs.sock (address="auto")."""
    from ray_tpu_torch._private.node import live_session_sockets

    socks = live_session_sockets("gcs.sock")
    if socks:
        return socks[0]
    raise ConnectionError(
        "address='auto' found no live ray_tpu_torch cluster "
        "(no connectable session_*/gcs.sock under the session root)")


def _attach_driver(node: Node):
    """Wire the driver-side WorkerContext to a (head) node's services."""
    scheduler = node.scheduler

    def driver_rpc(method: str, params: dict):
        return scheduler._handle_rpc(method, params)

    ctx = WorkerContext(
        mode="driver",
        store=node.new_store_client(),
        submit_fn=scheduler.submit,
        rpc_fn=driver_rpc,
        worker_id=os.urandom(8),  # so runtime-context ids are non-empty
        node=node,
        seal_notify_fn=scheduler.note_sealed,
        gcs_address=node.gcs_address,
    )
    ctx.init_direct(driver_rpc)
    # Worker print()/stderr lines from every node surface on the driver's
    # stdout, prefixed with the producing worker (reference: log monitor ->
    # GCS pubsub -> driver).  RTPU_LOG_TO_DRIVER=0 disables.
    if os.environ.get("RTPU_LOG_TO_DRIVER", "1") != "0":
        import sys as _sys

        def _print_worker_lines(lines):
            for line in lines:
                print(line, file=_sys.stdout, flush=True)

        scheduler.log_sink = _print_worker_lines
    worker_mod.set_global_worker(ctx)
    # Driver-side sampling profiler (workers start theirs in worker_main):
    # the driver's own CPU time shows up in "continuous" profiles too.
    from ray_tpu_torch._private import profiling

    profiling.ensure_sampler()
    return ctx


def shutdown():
    global _global_node
    if _global_node is not None:
        node, _global_node = _global_node, None
        # Final profile flush needs the driver context: stop the sampler
        # BEFORE detaching it (a later init() resumes via ensure_sampler).
        from ray_tpu_torch._private import profiling
        from ray_tpu_torch._private import ref_tracker

        profiling.shutdown_sampler(flush=True)
        ref_tracker.shutdown_flusher(flush=False)  # driver refs die here
        ref_tracker.clear()
        worker_mod.set_global_worker(None)
        node.shutdown()
    else:
        # client mode: just drop the TCP connection
        ctx = worker_mod.global_worker_or_none()
        if ctx is not None:
            worker_mod.set_global_worker(None)
            close = getattr(ctx, "close", None)
            if close is not None:
                close()


def is_initialized() -> bool:
    return worker_mod.is_initialized()


def remote(*args, **options):
    """Decorator turning a function into a RemoteFunction or a class into an
    ActorClass.  Usable bare (``@remote``) or with options
    (``@remote(num_gpus=1)``)."""

    def make(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, options)
        return RemoteFunction(obj, options)

    if len(args) == 1 and not options and (
        callable(args[0]) or inspect.isclass(args[0])
    ):
        return make(args[0])
    if args:
        raise TypeError("remote() takes keyword options only")
    return make


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
):
    worker = global_worker()
    if isinstance(refs, ObjectRef):
        return worker.get_object(refs, timeout=timeout)
    if isinstance(refs, (list, tuple)):
        # The timeout bounds the whole call, not each ref.
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for r in refs:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            out.append(worker.get_object(r, timeout=remaining))
        return out
    raise TypeError(f"get expects ObjectRef or list, got {type(refs)}")


def put(value) -> ObjectRef:
    return global_worker().put_object(value)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    return global_worker().wait(refs, num_returns, timeout, fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill expects an ActorHandle")
    global_worker().rpc("kill_actor", {"actor_id": actor.actor_id,
                                       "no_restart": no_restart})


def cancel(ref: ObjectRef, *, force: bool = False):
    # A return object id is task_id (16B) + return index (4B).
    task_id = ref.binary()[:16]
    global_worker().rpc("cancel", {"task_id": task_id, "force": force})


def get_actor(name: str) -> ActorHandle:
    info = global_worker().rpc("get_actor_by_name", {"name": name})
    if info is None:
        raise ValueError(f"no live actor named {name!r}")
    return ActorHandle(info["actor_id"], info["class_name"])


def nodes() -> list:
    """Cluster node table (reference: ray.nodes()): one dict per node with
    NodeID, Alive, Resources, and head flag."""
    raw = global_worker().rpc("list_nodes", {})
    return [{"NodeID": n["node_id"].hex(), "Alive": n["alive"],
             "Resources": n["resources"], "Available": n["available"],
             "IsHead": n["is_head"]} for n in raw]


def cluster_resources() -> dict:
    """Total resources summed over all live nodes."""
    total: dict = {}
    for n in global_worker().rpc("list_nodes", {}):
        if n["alive"]:
            for k, v in n["resources"].items():
                total[k] = total.get(k, 0) + v
    return total


def available_resources() -> dict:
    """Currently-available resources summed over all live nodes.

    The local node's view is authoritative (live counters); peers are as
    of their last heartbeat."""
    local = global_worker().rpc("cluster_state", {})
    avail = dict(local["available_resources"])
    local_id = local.get("node_id")
    for n in global_worker().rpc("list_nodes", {}):
        if n["alive"] and n["node_id"] != local_id:
            for k, v in n["available"].items():
                avail[k] = avail.get(k, 0) + v
    return avail


class RuntimeContext:
    def __init__(self, worker: WorkerContext):
        self._worker = worker

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False

    def get_actor_id(self) -> Optional[str]:
        aid = self._worker.current_actor_id
        return aid.hex() if aid else None

    def get_task_id(self) -> Optional[str]:
        tid = self._worker.current_task_id
        return tid.hex() if tid else None

    def node_id_hex(self) -> str:
        """Hex id of the node this process runs on."""
        import os

        if self._worker.node is not None:  # driver
            return self._worker.node.node_id.hex()
        return os.environ.get("RAY_TPU_NODE_ID", "")

    def get_worker_id(self) -> str:
        return self._worker.worker_id.hex()


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(global_worker())
