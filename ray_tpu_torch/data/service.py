"""The client face of the data service, a shared input tier.

Counterpart of ``ray_tpu/data/service.py`` (the tf.data service's client
API, arXiv 2210.14826: ``register_dataset`` and ``from_dataset_id``) on
the port's runtime: a driver registers a NAMED
dataset job once; any number of trainers — same driver or other drivers on
the cluster — attach to a split and iterate batches produced by the shared
elastic worker tier (coordination, failover, caching:
``_private/data_service.py``).

    service.register("imagenet", ds, num_splits=4)
    it = service.attach("imagenet", split_id=0)   # a DataIterator
    for epoch in range(epochs):
        for batch in it.iter_batches(batch_size=256):
            ...

Each ``__iter__`` over the attached iterator is one EPOCH: the coordinator
holds an epoch barrier (epoch e+1 starts when every live consumer finished
epoch e) and serves epoch >= 1 from the first-epoch cache where it fits
``RTPU_DATA_CACHE_BYTES``.

Only ``Read``/``InputData`` sources followed by ``OneToOne`` chains can be
registered — barrier ops (shuffle/sort/join/...) need a materialization
boundary, so ``.materialize()`` first and register the result.  A job
spec larger than the data executor's ``INLINE_MAX`` (read tasks holding
``from_items`` rows, an actor stage's UDF) reaches the coordinator through
the store, as the executor sends such blobs.
"""

from __future__ import annotations

from typing import Any, List, Optional

import cloudpickle

import ray_tpu_torch as rt
from ray_tpu_torch._private.data_service import (
    COORDINATOR_NAME,
    DataServiceCoordinator,
)
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.executor import _by_store
from ray_tpu_torch.data.iterator import DataIterator


def _decompose(plan: L.LogicalPlan) -> dict:
    """Lower a dataset plan into the service's chunked job spec: the source
    defines the chunks (one per read task / input bundle — the unit of
    lease, failover, and caching), the OneToOne chain runs inline on the
    feeding workers."""
    if not plan.ops:
        raise ValueError("cannot register an empty dataset plan")
    head, rest = plan.ops[0], plan.ops[1:]
    spec: dict = {"target_bytes": DataContext.get_current()
                  .target_max_block_size}
    if isinstance(head, L.Read):
        spec["kind"] = "read"
        spec["tasks"] = [cloudpickle.dumps(t) for t in head.read_tasks]
    elif isinstance(head, L.InputData):
        spec["kind"] = "input"
        spec["bundles"] = list(head.bundles)
    else:
        raise ValueError(
            f"data service jobs must start from a Read or InputData source, "
            f"got {type(head).__name__} ({head.name})")
    stages: List[dict] = []
    for op in rest:
        if not isinstance(op, L.OneToOne):
            raise ValueError(
                f"data service jobs support per-chunk (OneToOne) transforms "
                f"only; {op.name} ({type(op).__name__}) is a barrier op — "
                f"call .materialize() before register() to fold it in")
        if op.compute == "actors":
            stages.append({
                "kind": "actors", "name": op.name,
                "udf": cloudpickle.dumps(
                    (op.udf_cls, op.udf_args, op.udf_kwargs)),
                "make_fn": cloudpickle.dumps(op.block_fn)})
        else:
            stages.append({"kind": "tasks", "name": op.name,
                           "fn": cloudpickle.dumps(op.block_fn)})
    spec["stages"] = stages
    return spec


def _coordinator(create: bool = True):
    """Get the cluster's dispatcher actor, creating it on first use.  The
    create race (two drivers registering concurrently) resolves by retrying
    the named lookup."""
    try:
        return rt.get_actor(COORDINATOR_NAME)
    except ValueError:
        if not create:
            raise
    try:
        coord = rt.remote(DataServiceCoordinator).options(
            name=COORDINATOR_NAME, num_cpus=0, max_concurrency=32).remote()
        rt.get(coord.list_jobs.remote())  # force creation/readiness
        return coord
    except Exception:
        return rt.get_actor(COORDINATOR_NAME)


def register(name: str, dataset: Any, num_splits: int = 1, *,
             min_workers: Optional[int] = None,
             max_workers: Optional[int] = None) -> dict:
    """Register ``dataset`` as the named job ``name`` served by the data
    service.  Splits are disjoint chunk sets (chunk i -> split i % n); the
    worker pool scales between min/max (defaults:
    RTPU_DATA_WORKERS_MIN/MAX)."""
    spec = _decompose(dataset._plan)
    coord = _coordinator()
    return rt.get(coord.register_job.remote(
        name, _by_store(cloudpickle.dumps(spec)), num_splits,
        min_workers, max_workers))


class _ServiceSplit:
    """Re-iterable bundle source for one split: each ``__iter__`` is one
    epoch (the coordinator's barrier gates when it actually starts)."""

    def __init__(self, coord, name: str, split: int, consumer_id: str):
        self._coord = coord
        self._name = name
        self._split = split
        self._cid = consumer_id
        self._epoch = 0

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        while True:
            resp = rt.get(self._coord.next_bundles.remote(
                self._name, self._split, self._cid, epoch))
            if resp.get("eof"):
                return
            if resp.get("pending"):
                continue  # server already blocked its timeout slice
            for ref, meta in resp["bundles"]:
                yield (ref, meta)


def attach(name: str, split_id: int) -> DataIterator:
    """Attach to one split of a registered job; returns a ``DataIterator``
    (iter_batches / iter_rows / iter_torch_batches...).  The consumer lease
    is refreshed by consumption and expires after RTPU_DATA_LEASE_S of
    silence."""
    coord = _coordinator(create=False)
    lease = rt.get(coord.attach.remote(name, split_id))
    return DataIterator(_ServiceSplit(coord, name, split_id,
                                      lease["consumer_id"]))


def unregister(name: str) -> bool:
    """Stop a job: kill its workers, drop its plan and cache pins."""
    coord = _coordinator(create=False)
    return rt.get(coord.unregister.remote(name))


def scale(name: str, min_workers: Optional[int] = None,
          max_workers: Optional[int] = None) -> dict:
    """Adjust a job's worker-pool bounds (driver-side twin of
    ``rtpu data scale``)."""
    coord = _coordinator(create=False)
    return rt.get(coord.scale.remote(name, min_workers, max_workers))


def describe(name: str) -> dict:
    """Live status snapshot of one job (splits, workers, queue depths,
    cache hit/miss, failovers)."""
    coord = _coordinator(create=False)
    return rt.get(coord.stats.remote(name))


def jobs() -> list:
    """Status snapshots of every registered job."""
    try:
        coord = _coordinator(create=False)
    except ValueError:
        return []
    return rt.get(coord.list_jobs.remote())
