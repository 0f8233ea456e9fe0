"""PyTorch/CUDA port of ray_tpu's compute layer.

Mirrors the JAX package's paths (``ops/``, ``models/``, ``llm/``,
``train/``).  Imports ``torch`` and nothing of JAX or ``ray_tpu``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""
