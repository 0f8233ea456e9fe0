"""Joblib ParallelBackend over the port's tasks.

Counterpart of ``ray_tpu/util/joblib/ray_backend.py``.  Ray's backend
(python/ray/util/joblib/ray_backend.py) subclasses the multiprocessing
pool backend over Ray's Pool; here each joblib batch maps directly to one
task, which is simpler and equivalent for joblib's call pattern (joblib
sizes the batches itself).
"""

from __future__ import annotations

import threading

from joblib._parallel_backends import ParallelBackendBase, SequentialBackend

import ray_tpu_torch


class _Result:
    def __init__(self, ref):
        self._ref = ref

    def get(self, timeout=None):
        return ray_tpu_torch.get(self._ref, timeout=timeout)


# Module-level so the driver's function cache registers it once: a closure
# made per call would be pickled and registered again for every batch.
@ray_tpu_torch.remote
def _run_batch(f):
    return f()


class RayTpuBackend(ParallelBackendBase):
    supports_timeout = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._n_jobs = 1

    def configure(self, n_jobs: int = 1, parallel=None, **kwargs) -> int:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self.parallel = parallel
        n_jobs = self.effective_n_jobs(n_jobs)
        self._n_jobs = n_jobs
        return n_jobs

    def effective_n_jobs(self, n_jobs: int) -> int:
        if n_jobs == 0:
            raise ValueError("n_jobs == 0 is not valid")
        if n_jobs < 0:
            cpus = ray_tpu_torch.cluster_resources().get("CPU", 1) \
                if ray_tpu_torch.is_initialized() else 1
            return max(1, int(cpus))
        return n_jobs

    def apply_async(self, func, callback=None):
        result = _Result(_run_batch.remote(func))
        if callback is not None:
            def waiter():
                try:
                    callback(result.get())
                except Exception:
                    # joblib reads the batch's error through result.get()
                    pass

            threading.Thread(target=waiter, daemon=True).start()
        return result

    def get_nested_backend(self):
        return SequentialBackend(nesting_level=self.nesting_level + 1), None

    def abort_everything(self, ensure_ready=True):
        pass
