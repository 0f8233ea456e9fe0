"""Dask-on-Ray: execute dask task graphs on the port's runtime.

Counterpart of ``ray_tpu/util/dask/``, that is, of Ray's
python/ray/util/dask/ (scheduler.py ``ray_dask_get``): a drop-in dask
scheduler that turns each graph task into a task of the port's runtime,
so the cluster's scheduler and object store replace dask's local thread
pool.  Works on raw dask-spec graphs (plain dicts of
``key -> (callable, *args)``) without dask installed; dask itself is only
needed for ``enable_dask_on_ray()``, which registers this as the default
scheduler via ``dask.config``.
"""

from ray_tpu_torch.util.dask.scheduler import (
    disable_dask_on_ray,
    enable_dask_on_ray,
    ray_dask_get,
)

__all__ = ["ray_dask_get", "enable_dask_on_ray", "disable_dask_on_ray"]
