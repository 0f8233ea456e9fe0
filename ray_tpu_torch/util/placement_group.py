"""Placement groups: gang reservation of resource bundles.

Counterpart of ``ray_tpu/util/placement_group.py``; that is, of the
reference's (Ray's python/ray/util/placement_group.py:42,146; the GCS-side
2PC scheduler lives in gcs_placement_group_scheduler.cc).  On the GPU
build, bundles are how a gang of workers is reserved: a training job asks
for one ``{"CPU": 1, "GPU": 1}`` bundle per worker, with ``STRICT_PACK``
so the gang lands on one host.  Bundles are assigned to cluster nodes by
strategy (PACK/SPREAD/STRICT_PACK/STRICT_SPREAD) and 2PC-reserved on each
(``_private/scheduler.py``'s ``create_placement_group``); tasks using a
bundle run on its node (the scheduler routes by the GCS bundle map).
Creation is synchronous: ``ready``/``wait`` resolve immediately.
"""

from __future__ import annotations

import os
from typing import Optional

from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.exceptions import PlacementGroupUnavailableError

PACK = "PACK"
SPREAD = "SPREAD"
STRICT_PACK = "STRICT_PACK"
STRICT_SPREAD = "STRICT_SPREAD"
VALID_STRATEGIES = (PACK, SPREAD, STRICT_PACK, STRICT_SPREAD)


class PlacementGroup:
    def __init__(self, pg_id: bytes, bundles: list[dict], strategy: str):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self):
        """Return an ObjectRef resolvable once the group is reserved."""
        # Reservation is synchronous; hand back a sealed ref.
        return global_worker().put_object(True)

    def wait(self, timeout_seconds: float = 30) -> bool:
        return True

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs, self.strategy))


def placement_group(
    bundles: list[dict],
    strategy: str = PACK,
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"invalid strategy {strategy!r}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    worker = global_worker()
    pg_id = os.urandom(16)
    ok = worker.rpc(
        "create_placement_group",
        {"pg_id": pg_id, "bundles": bundles, "strategy": strategy},
    )
    if not ok:
        raise PlacementGroupUnavailableError(
            f"cannot reserve bundles {bundles}: insufficient resources"
        )
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup):
    global_worker().rpc("remove_placement_group", {"pg_id": pg.id})


def placement_group_table() -> dict:
    return global_worker().rpc("pg_table", {})
