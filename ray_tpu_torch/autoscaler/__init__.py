"""ray_tpu_torch.autoscaler: demand-driven cluster scaling.

Counterpart of ``ray_tpu/autoscaler/`` (Ray's python/ray/autoscaler/,
v2-shaped: a reconciler over a NodeProvider; the fake provider launches
real local node processes for tests, as Ray's fake_multi_node does).
``v2`` holds the declarative instance reconciler and ``GPUSliceProvider``.
"""

from ray_tpu_torch.autoscaler.autoscaler import (
    AutoscalerConfig,
    NodeTypeConfig,
    StandardAutoscaler,
)
from ray_tpu_torch.autoscaler.node_provider import FakeNodeProvider, NodeProvider

__all__ = [
    "AutoscalerConfig",
    "FakeNodeProvider",
    "NodeProvider",
    "NodeTypeConfig",
    "StandardAutoscaler",
]
