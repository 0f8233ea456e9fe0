"""Parallelism layer: device mesh, logical sharding rules, GPipe pipeline
and the comm estimator.

Counterpart of ``ray_tpu/parallel``.  The code is per-rank SPMD over
``torch.distributed``: a mesh is a ``DeviceMesh`` over the initialised
process group, and every function takes the rank's local shards where the
JAX package's ``shard_map`` hands its body the local blocks.  ``comm`` is
pure arithmetic, a copy of the JAX package's.
"""
