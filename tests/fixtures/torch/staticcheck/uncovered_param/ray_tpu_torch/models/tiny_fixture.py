"""Fixture model: one spec uses an axis the rules don't know, so the
parameter silently maps to fully-replicated."""

from ray_tpu_torch.parallel.sharding import logical_spec as L

X_SPEC = L("batch")
W_SPEC = L("widgets", None)  # "widgets" unknown to the rules
