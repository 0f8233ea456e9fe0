"""Task specification: the unit of work the runtime schedules.

Counterpart of the reference's ``TaskSpecification``
(Ray's src/ray/common/task/task_spec.h): one record carrying
everything a node needs to execute a task, an actor creation, or an actor
method — function blob id, pickled args, return object ids, resource asks,
placement-group/bundle binding, retry budgets, and cluster-scheduling
bookkeeping (spill counts, affinity, origin node for spillback recovery).
"""

from __future__ import annotations

import os

from dataclasses import dataclass, field
from typing import Optional

TASK = "task"
ACTOR_CREATION = "actor_creation"
ACTOR_METHOD = "actor_method"

# Cross-node object transfer chunk (reference: object_manager.h:53
# object_chunk_size, ~1-5MB); bounds per-message memory during pulls.
FETCH_CHUNK = int(os.environ.get("RTPU_FETCH_CHUNK", 4 << 20))
# A task may spill between nodes at most this many times before it settles
# where it is (prevents forwarding ping-pong under racing load reports).
MAX_SPILLS = 4  # default; spill decisions read the
# RTPU_MAX_SPILLS flag at use time (cluster-adoption safe)


@dataclass
class TaskSpec:
    task_id: bytes
    kind: str  # TASK | ACTOR_CREATION | ACTOR_METHOD
    fn_id: bytes  # GCS KV key of the pickled function/class
    args_blob: bytes  # cloudpickle of (args, kwargs) with ObjectRef markers
    return_ids: list[bytes]
    resources: dict = field(default_factory=dict)
    actor_id: Optional[bytes] = None
    method_name: Optional[str] = None
    name: str = ""
    max_retries: int = 0
    retries_left: int = 0
    max_restarts: int = 0
    max_concurrency: int = 1
    actor_name: Optional[str] = None
    pg_id: Optional[bytes] = None
    pg_bundle: Optional[int] = None
    runtime_env: Optional[dict] = None
    # "device": return value stays resident on the producing actor (card
    # memory for CUDA tensors); the store gets a marker (reference: GPU objects / RDT,
    # python/ray/_private/gpu_object_manager.py:16)
    tensor_transport: Optional[str] = None
    # cluster scheduling (reference: hybrid policy spillback,
    # src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.cc, and
    # NodeAffinitySchedulingStrategy, util/scheduling_strategies.py:41)
    spill_count: int = 0
    node_affinity: Optional[bytes] = None
    affinity_soft: bool = True
    origin_node: Optional[bytes] = None  # forwarder to notify on completion
    # NodeLabelSchedulingStrategy: hard selector must match the executing
    # node's labels; soft is a preference among feasible nodes
    label_selector: Optional[dict] = None
    label_selector_soft: Optional[dict] = None
    # ObjectRef arguments captured at submission (escape-hook collector in
    # worker.py): lets a forwarding node PUSH locally-present args to the
    # target ahead of execution (reference: push_manager.cc; the deps the
    # reference carries in its TaskSpec protobuf)
    dependencies: Optional[list] = None
    # Distributed-tracing context stamped at submission (util.tracing):
    # rides the pickled spec through every lane — scheduler conn, native
    # raylet frames, nested submits, direct actor calls — so the worker
    # can parent its execution span and nested calls under the caller.
    trace_id: Optional[str] = None
    parent_span_id: Optional[str] = None
    trace_submit_ts: float = 0.0


def is_plain_task(spec: TaskSpec) -> bool:
    """True when the spec qualifies for the native raylet's fast lane
    (core_worker.cc RayletCore): a stateless task whose dispatch needs no
    Python policy — no placement group, affinity, label, runtime env, or
    device-resident returns, and only CPU resource demands.  Everything
    else takes the Python scheduler path."""
    if spec.kind != TASK:
        return False
    if (spec.pg_id is not None or spec.node_affinity is not None
            or spec.label_selector or spec.label_selector_soft
            or spec.runtime_env or spec.tensor_transport is not None):
        return False
    res = spec.resources or {}
    return all(k == "CPU" for k in res)
