"""Logical plan: declarative description of a Dataset's computation.

Counterpart of ``ray_tpu/data/logical.py`` (Ray's
python/ray/data/_internal/logical/operators/*, _internal/plan.py): Dataset
methods append logical ops; nothing executes until consumption, when the
planner lowers the logical chain to physical operators, fusing adjacent
maps (``data/executor.py`` ``plan_physical``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple


@dataclass
class LogicalOp:
    name: str = "op"


@dataclass
class InputData(LogicalOp):
    """Already-materialized (block_ref, metadata) pairs."""

    bundles: List[Tuple[Any, Any]] = field(default_factory=list)


@dataclass
class Read(LogicalOp):
    """A list of read tasks, each a zero-arg callable yielding blocks
    (Ray: planner/plan_read_op.py over Datasource.get_read_tasks)."""

    read_tasks: List[Callable] = field(default_factory=list)


@dataclass
class OneToOne(LogicalOp):
    """A per-block transform: fn(iter[Block]) -> iter[Block].

    Covers MapBatches / MapRows / Filter / FlatMap / Project: all are
    block-level generator transforms, which makes fusion a composition.
    """

    block_fn: Optional[Callable] = None
    # "tasks" or "actors" (Ray: compute strategies, map_operator.py)
    compute: str = "tasks"
    # For actor compute: the UDF class + constructor args; workers construct
    # one instance per actor and reuse it across calls.
    udf_cls: Any = None
    udf_args: tuple = ()
    udf_kwargs: dict = field(default_factory=dict)
    concurrency: Optional[int] = None
    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None  # the JAX package's num_tpus
    memory: Optional[float] = None


@dataclass
class AllToAll(LogicalOp):
    """A barrier op: fn(list[(ref, meta)], ctx) -> list[(ref, meta)].

    Covers repartition / random_shuffle / sort / groupby-aggregate
    (Ray: _internal/planner/exchange/*).
    """

    bulk_fn: Optional[Callable] = None


@dataclass
class Union(LogicalOp):
    others: List[Any] = field(default_factory=list)  # list[LogicalPlan]


@dataclass
class Zip(LogicalOp):
    other: Any = None  # LogicalPlan


@dataclass
class Join(LogicalOp):
    """Hash join with another plan (Ray:
    _internal/execution/operators/join.py + hash_shuffle.py)."""

    other: Any = None  # LogicalPlan
    on: tuple = ()  # join key column(s)
    how: str = "inner"  # inner | left | right | outer
    num_partitions: Optional[int] = None


@dataclass
class Limit(LogicalOp):
    limit: int = 0


class LogicalPlan:
    def __init__(self, ops: Optional[List[LogicalOp]] = None):
        self.ops: List[LogicalOp] = ops or []

    def with_op(self, op: LogicalOp) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def __repr__(self):
        return " -> ".join(op.name for op in self.ops) or "(empty)"
