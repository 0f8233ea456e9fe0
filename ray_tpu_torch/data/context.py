"""DataContext: per-session execution configuration for the data package.

Counterpart of ``ray_tpu/data/context.py`` (Ray's
python/ray/data/context.py): a process-wide singleton of execution knobs
consulted by the planner and the streaming executor.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class DataContext:
    # Target size for output blocks produced by map tasks; oversized outputs
    # are sliced (Ray: context.py target_max_block_size = 128 MiB).
    target_max_block_size: int = 128 * 1024 * 1024
    # Default number of output blocks for reads when not specified.
    default_parallelism: int = field(
        default_factory=lambda: max(4, (os.cpu_count() or 4)))
    # Bound on concurrently running tasks per map operator: the streaming
    # executor's backpressure window (Ray: backpressure_policy/
    # concurrency_cap_backpressure_policy.py).
    max_tasks_in_flight_per_op: int = field(
        default_factory=lambda: max(4, (os.cpu_count() or 4)))
    # In-flight method calls allowed per actor in actor-pool map ops
    # (Ray: _max_tasks_in_flight_per_actor, actor_pool_map_operator.py).
    max_tasks_in_flight_per_actor: int = 2
    # Default rows per batch for map_batches / iter_batches.
    target_batch_size: int = 1024
    # Seconds to wait for an actor pool to become ready.
    wait_for_min_actors_s: int = 60
    # Retries for data tasks (transient worker crashes).
    task_max_retries: int = 2
    # Pluggable launch-gating policies consulted by every task-launching
    # operator (Ray: _internal/execution/backpressure_policy/).  None =
    # data.backpressure.default_policies() (concurrency cap + output-bytes
    # bound); install custom BackpressurePolicy instances to change
    # admission behaviour.
    backpressure_policies: Optional[list] = None

    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def get_current() -> "DataContext":
        # Process-wide singleton: executor generators may be pulled from
        # prefetch threads, so knobs set on the main thread must be visible
        # everywhere (Ray: context.py get_current).
        if DataContext._instance is None:
            with DataContext._lock:
                if DataContext._instance is None:
                    DataContext._instance = DataContext()
        return DataContext._instance
