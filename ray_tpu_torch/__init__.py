"""PyTorch/CUDA port of ray_tpu.

Mirrors the JAX package's paths (``ops/``, ``models/``, ``llm/``,
``train/``, ``parallel/``, ``rllib/``, and the runtime: ``api.py``,
``core/``, ``_private/``, ``native/``, ``experimental/``).  Imports
``torch`` and nothing of JAX or ``ray_tpu``.  Entry points run on CUDA
unless the caller passes ``device="cpu"``.  The top level exports the
runtime's API, as ``ray_tpu/__init__.py`` does.
"""

from ray_tpu_torch._version import __version__
from ray_tpu_torch.api import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.core.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch import exceptions

__all__ = [
    "__version__",
    "ActorClass",
    "ActorHandle",
    "ObjectRef",
    "available_resources",
    "cancel",
    "cluster_resources",
    "exceptions",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "wait",
]
