"""ray_tpu_torch.experimental: device objects (direct transport).

Counterpart of Ray's python/ray/experimental/ (GPU objects /
RDT surface).
"""

from ray_tpu_torch._private.device_objects import (
    DeviceObjectMarker,
    get_device_object,
    free_device_object,
)

__all__ = ["DeviceObjectMarker", "free_device_object",
           "get_device_object"]
