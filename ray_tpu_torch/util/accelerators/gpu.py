"""GPU node facts: the counterpart of ``tpu.py``'s node helpers.

``ray_tpu_torch.util.accelerators.gpu`` describes the node the port runs
on: how many cards it has (what ``rtpu start`` and ``init`` advertise as
``"GPU"``) and the variable through which the scheduler shows a worker
the cards it was granted (as ``TPU_VISIBLE_CHIPS`` does for chips).
"""

from __future__ import annotations

# set by the scheduler on a worker it grants cards to (Ray's
# _private/accelerators/nvidia_gpu.py)
CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"


def get_num_gpus_on_node() -> int:
    """Cards visible to this host: ``RAY_TPU_NUM_GPUS`` if set, else
    ``torch.cuda.device_count()`` (no CUDA context is made); 0 where
    there is none."""
    from ray_tpu_torch._private.node import detect_num_gpus

    return detect_num_gpus()
