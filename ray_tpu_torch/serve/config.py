"""Serve configs.

Counterpart of ``ray_tpu/serve/config.py``; that is, of the reference's
Serve config schema (Ray's python/ray/serve/config.py AutoscalingConfig,
python/ray/serve/_private/config.py DeploymentConfig).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 5.0
    # scaling decisions use the PEAK load over this window, not the
    # instantaneous sample (reference: autoscaling_policy look_back_period_s,
    # default 30s): a burst shorter than replica startup must not flap the
    # target back down before the new replicas ever serve
    look_back_period_s: float = 30.0


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    autoscaling_config: Optional[AutoscalingConfig] = None
    user_config: Optional[Dict[str, Any]] = None
    health_check_period_s: float = 2.0
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    graceful_shutdown_timeout_s: float = 5.0
    # which serve/request_router policy handles pick for this deployment
    # ("pow2" | "prefix_aware"); advertised by the controller alongside
    # the replica set so handles never need the deployment code to route
    request_router_policy: str = "pow2"
