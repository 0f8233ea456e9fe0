"""Joblib backend: scikit-learn's n_jobs parallelism on the cluster.

Counterpart of ``ray_tpu/util/joblib/``, that is, of Ray's
python/ray/util/joblib/ (``register_ray`` and ray_backend.py):
``register_ray()`` then ``with joblib.parallel_backend("ray_tpu"): ...``
runs every joblib batch as a task of the port's runtime.  joblib is
imported only here, so the package imports where joblib is absent.
"""

from __future__ import annotations

__all__ = ["register_ray"]


def register_ray() -> None:
    try:
        from joblib.parallel import register_parallel_backend
    except ImportError as e:
        raise ImportError("joblib is required for the ray_tpu joblib "
                          "backend") from e
    from ray_tpu_torch.util.joblib.ray_backend import RayTpuBackend

    register_parallel_backend("ray_tpu", RayTpuBackend)
    # Ray registers under "ray"; accept that spelling too
    register_parallel_backend("ray", RayTpuBackend)
