"""Carry JAX parameter trees (as numpy) into the port unchanged.

The JAX package's Llama, GPT-2 and MoE parameters are nested dicts of arrays
with layers stacked on a leading axis, and its RLlib MLPs keep their torso
as a list of layers; the port keeps those layouts and keys, so one walk
serves them all.  The caller turns the JAX tree into numpy
(``jax.tree.map(np.asarray, params)``) so that nothing here imports JAX.
No value is cast: the forwards cast matmul weights and norms to
``cfg.dtype`` on use and keep ``lm_head`` in f32 where JAX does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret bits
        t = torch.from_numpy(np.array(a).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device)


def params_from_jax(tree: Dict, device: DeviceLike = None) -> Dict:
    """A port state with the same keys and values as the numpy tree, on
    ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return _tensor(node, dev)

    return walk(tree)


llama_params_from_jax = params_from_jax
gpt2_params_from_jax = params_from_jax
moe_params_from_jax = params_from_jax
rllib_params_from_jax = params_from_jax
