"""Accelerator facts (``ray_tpu_torch.util.accelerators``).

Counterpart of ``ray_tpu/util/accelerators/`` (Ray's
python/ray/util/accelerators/): ``tpu`` keeps the JAX package's TPU
generation and pod facts, ``gpu`` describes the port's GPU node.
"""

from ray_tpu_torch.util.accelerators import gpu, tpu

__all__ = ["gpu", "tpu"]
