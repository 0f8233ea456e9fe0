"""ray_tpu_torch.dashboard: REST + Prometheus observability head.

Counterpart of Ray's python/ray/dashboard/ (head process only;
JSON API instead of the React SPA).
"""

from ray_tpu_torch.dashboard.head import DashboardHead

__all__ = ["DashboardHead"]
