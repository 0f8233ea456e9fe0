"""Remote functions: ``@ray_tpu_torch.remote`` on a function.

Counterpart of Ray's python/ray/remote_function.py: holds task
options (resources, num_returns, retries, scheduling strategy), registers the
pickled function in the store-backed function registry once per session, and
builds TaskSpecs for submission.
"""

from __future__ import annotations

from typing import Any, Optional

import cloudpickle

from ray_tpu_torch._private import ids
from ray_tpu_torch._private import ref_tracker
from ray_tpu_torch._private.runtime_env import package as package_runtime_env
from ray_tpu_torch._private.task_spec import TASK, TaskSpec
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.util import tracing

def resolve_resources(options: dict, default_num_cpus: float = 1) -> dict:
    res = dict(options.get("resources") or {})
    num_cpus = options.get("num_cpus")
    num_gpus = options.get("num_gpus")
    if num_cpus is None:
        # Tasks default to 1 CPU; actors to 0 (they hold resources for their
        # whole lifetime, so a nonzero default would starve the pool —
        # matching the reference's actor defaults).
        num_cpus = default_num_cpus
    if num_cpus:
        res["CPU"] = float(num_cpus)
    if num_gpus:
        res["GPU"] = float(num_gpus)
    if options.get("memory"):
        res["memory"] = float(options["memory"])
    return res


def strategy_fields(options: dict) -> dict:
    """Extract pg routing / node affinity from a scheduling_strategy."""
    strategy = options.get("scheduling_strategy")
    pg = options.get("placement_group")
    bundle = options.get("placement_group_bundle_index")
    if strategy is not None and hasattr(strategy, "placement_group"):
        pg = strategy.placement_group
        bundle = strategy.placement_group_bundle_index
    if pg is not None:
        return {"pg_id": pg.id,
                "pg_bundle": 0 if bundle in (None, -1) else bundle}
    if strategy is not None and hasattr(strategy, "hard"):
        # NodeLabelSchedulingStrategy
        return {"label_selector": dict(strategy.hard) or None,
                "label_selector_soft": dict(strategy.soft) or None}
    if strategy is not None and hasattr(strategy, "node_id"):
        # NodeAffinitySchedulingStrategy: node_id is hex (as returned by
        # ray_tpu_torch.nodes()) or raw bytes
        nid = strategy.node_id
        if isinstance(nid, str):
            nid = bytes.fromhex(nid)
        return {"node_affinity": nid,
                "affinity_soft": bool(getattr(strategy, "soft", False))}
    return {}


class RemoteFunction:
    def __init__(self, function, options: Optional[dict] = None):
        self._function = function
        self._options = options or {}
        self.__name__ = getattr(function, "__name__", "remote_fn")

    def options(self, **task_options) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(task_options)
        return RemoteFunction(self._function, merged)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def _remote(self, args, kwargs, options: dict):
        worker = global_worker()
        fn_id = worker.register_function(self._function)
        task_id = ids.new_task_id()
        num_returns = options.get("num_returns", 1)
        return_ids = [ids.object_id_for_return(task_id, i)
                      for i in range(num_returns)]
        collect = getattr(worker, "collect_escaped_refs", None)
        if collect is not None:
            with collect() as deps:
                args_blob = cloudpickle.dumps((list(args), dict(kwargs)))
            dependencies = deps or None
        else:
            args_blob = cloudpickle.dumps((list(args), dict(kwargs)))
            dependencies = None
        spec = TaskSpec(
            task_id=task_id,
            kind=TASK,
            fn_id=fn_id,
            args_blob=args_blob,
            return_ids=return_ids,
            resources=resolve_resources(options),
            name=options.get("name") or self.__name__,
            max_retries=options.get("max_retries", 3),
            runtime_env=package_runtime_env(
                options.get("runtime_env"), worker),
            dependencies=dependencies,
            **strategy_fields(options),
        )
        tracing.attach_trace(spec)
        worker.submit(spec)
        # Owner-side lineage: lost outputs re-execute this spec (client
        # proxy contexts have no lineage store — getattr guard).
        record = getattr(worker, "record_lineage", None)
        if record is not None:
            record(spec)
        refs = [ObjectRef(oid) for oid in return_ids]
        for oid in return_ids:
            ref_tracker.annotate(oid, kind="task_return")
        return refs[0] if num_returns == 1 else refs

    def __call__(self, *args: Any, **kwargs: Any):
        raise TypeError(
            f"Remote function {self.__name__!r} cannot be called directly; "
            f"use {self.__name__}.remote()."
        )
