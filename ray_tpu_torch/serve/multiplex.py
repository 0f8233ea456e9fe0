"""Model multiplexing: many models per replica with LRU residency.

Counterpart of ``ray_tpu/serve/multiplex.py``, the reference's
serve.multiplexed / get_multiplexed_model_id
(Ray's python/ray/serve/multiplex.py and
llm/_internal/serve/deployments/llm/multiplex/): a handle call made with
``.options(multiplexed_model_id=...)`` routes with affinity (handle.py) and
carries the id to the replica; inside, a ``@serve.multiplexed`` loader keeps
up to N models resident per replica (LoRA adapters in the LLM case: torch
modules or tensors on the card, so eviction frees device memory).
"""

from __future__ import annotations

import contextvars
import threading
from collections import OrderedDict
from functools import wraps
from typing import Callable, Optional

_current_model_id: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("rtpu_multiplexed_model_id", default=None)


def get_multiplexed_model_id() -> Optional[str]:
    """Inside a replica: the model id the current request was routed with."""
    return _current_model_id.get()


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorate a per-model loader method; calls are LRU-cached per
    replica instance:

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            return load_adapter(model_id)
    """

    def decorate(fn: Callable) -> Callable:
        @wraps(fn)
        def wrapper(self, model_id: str):
            cache = self.__dict__.get("_rtpu_multiplex_cache")
            if cache is None:
                cache = self.__dict__["_rtpu_multiplex_cache"] = \
                    OrderedDict()
                self.__dict__["_rtpu_multiplex_lock"] = threading.Lock()
            lock = self.__dict__["_rtpu_multiplex_lock"]
            with lock:
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
            model = fn(self, model_id)  # load OUTSIDE the lock (slow)
            with lock:
                if model_id in cache:
                    # a concurrent request loaded it first: keep ONE copy
                    # resident (device memory) and drop ours
                    cache.move_to_end(model_id)
                    return cache[model_id]
                cache[model_id] = model
                cache.move_to_end(model_id)
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)  # evict LRU -> frees memory
            return model

        return wrapper

    if func is not None:
        return decorate(func)
    return decorate
