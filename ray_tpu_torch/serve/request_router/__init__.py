"""Pluggable request routers for serve deployments.

Counterpart of ``ray_tpu/serve/request_router/``: a per-(app, deployment)
router object shared by every handle in the process.  Routing state
(in-flight counts, the prefix tree, replica stats) lives here, so two
handles to the same deployment agree on placement.  The policies are
``"pow2"`` and ``"prefix_aware"``.  The routers are host code: they route
to anything with an ``actor_id``, such as the port's engines behind
``_private/serve_bench.py``.
"""

from ray_tpu_torch.serve.request_router.base import (ReplicaStats,
                                                     RequestRouter,
                                                     get_router,
                                                     router_snapshots)
from ray_tpu_torch.serve.request_router.pow2 import Pow2Router
from ray_tpu_torch.serve.request_router.prefix_aware import (
    PrefixAwareRouter, PrefixTree)

__all__ = [
    "ReplicaStats", "RequestRouter", "Pow2Router", "PrefixAwareRouter",
    "PrefixTree", "get_router", "router_snapshots",
]
