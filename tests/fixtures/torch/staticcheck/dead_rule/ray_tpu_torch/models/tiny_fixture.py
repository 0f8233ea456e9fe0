"""Fixture model: uses only the "batch" logical axis, through the alias
the port's models use."""

from ray_tpu_torch.parallel.sharding import logical_spec as L

X_SPEC = L("batch")
