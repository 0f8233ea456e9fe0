"""Actor classes and handles: ``@ray_tpu_torch.remote`` on a class.

Counterpart of Ray's python/ray/actor.py (ActorClass/ActorHandle):
``ActorClass.remote()`` submits an actor-creation task that dedicates a pooled
worker process to the instance; ``handle.method.remote()`` submits ordered
method-call tasks routed to that worker.  Handles are plain data (actor id)
and can be pickled into tasks; named actors are resolved via the GCS.
"""

from __future__ import annotations

import pickle
from typing import Optional

import cloudpickle

from ray_tpu_torch._private import ids
from ray_tpu_torch._private import ref_tracker
from ray_tpu_torch._private.task_spec import ACTOR_CREATION, ACTOR_METHOD, TaskSpec
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch._private.runtime_env import package as package_runtime_env
from ray_tpu_torch.core.remote_function import resolve_resources, strategy_fields
from ray_tpu_torch.util import tracing


def dumps_args(payload) -> bytes:
    """The argument-serialization policy, shared by the full submit path
    and the worker's actor fastlane: stdlib pickle first (its C
    implementation is ~3x cloudpickle for plain-data args and runs the
    same ObjectRef escape hooks via __reduce__), cloudpickle when pickle
    can't (closures/lambdas) or when the blob references __main__ —
    stdlib pickles driver-script classes BY REFERENCE, which a worker
    process cannot resolve (cloudpickle ships them by value).  The
    b"__main__" scan is conservative: a false positive merely costs the
    cloudpickle path."""
    try:
        blob = pickle.dumps(payload, protocol=5)
        if b"__main__" in blob:
            return cloudpickle.dumps(payload)
        return blob
    except Exception:
        return cloudpickle.dumps(payload)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str):
        self._handle = handle
        self._method_name = method_name
        self._fast = None  # worker.actor_fastlane closure, installed lazily

    def remote(self, *args, **kwargs):
        # Hot path: a fused submit over the cached direct channel
        # (worker.actor_fastlane).  A None result means "not eligible
        # right now" (no channel yet, channel dead, scheduler-path calls
        # draining) — drop to the full path, which handles every case,
        # and re-install on the next call in case the worker changed.
        fast = self._fast
        if fast is not None:
            ref = fast(args, kwargs)
            if ref is not None:
                return ref
            self._fast = None
        ref = self._handle._submit_method(
            self._method_name, args, kwargs, num_returns=1)
        if self._fast is None:
            make = getattr(global_worker(), "actor_fastlane", None)
            if make is not None:
                h = self._handle
                self._fast = make(
                    h._actor_id, self._method_name,
                    f"{h._class_name}.{self._method_name}")
        return ref

    def bind(self, *args, **kwargs):
        """DAG nodes (the JAX package's ``dag/``) are not part of the port
        yet."""
        raise NotImplementedError(
            "ray_tpu_torch has no dag/ yet: call .remote() instead of .bind()")

    def options(self, num_returns: int = 1,
                tensor_transport: Optional[str] = None, **_ignored):
        handle, name = self._handle, self._method_name
        if tensor_transport not in (None, "device", "object_store"):
            raise ValueError(
                f"tensor_transport must be 'device' or 'object_store', "
                f"got {tensor_transport!r}")

        class _Bound:
            def remote(self, *args, **kwargs):
                return handle._submit_method(
                    name, args, kwargs, num_returns=num_returns,
                    tensor_transport=(tensor_transport
                                      if tensor_transport != "object_store"
                                      else None))

        return _Bound()


class ActorHandle:
    def __init__(self, actor_id: bytes, class_name: str = ""):
        self._actor_id = actor_id
        self._class_name = class_name

    @property
    def actor_id(self) -> bytes:
        return self._actor_id

    def __getattr__(self, item):
        # __rtpu_apply__ is the universal hidden method (reference parity:
        # __ray_call__) — any other underscore name is a real miss.
        if item.startswith("_") and item != "__rtpu_apply__":
            raise AttributeError(item)
        method = ActorMethod(self, item)
        # cache on the instance: later `handle.method` accesses skip
        # __getattr__ entirely (the hot actor-call path pays for this)
        self.__dict__[item] = method
        return method

    def _submit_method(self, method_name, args, kwargs, num_returns=1,
                       tensor_transport=None):
        worker = global_worker()
        task_id = ids.new_task_id()
        return_ids = [ids.object_id_for_return(task_id, i)
                      for i in range(num_returns)]
        args_blob = dumps_args((list(args), dict(kwargs)))
        spec = TaskSpec(
            task_id=task_id,
            kind=ACTOR_METHOD,
            fn_id=b"",
            args_blob=args_blob,
            return_ids=return_ids,
            actor_id=self._actor_id,
            method_name=method_name,
            name=f"{self._class_name}.{method_name}",
            tensor_transport=tensor_transport,
        )
        tracing.attach_trace(spec)
        # Direct push when available (driver/worker contexts); the client
        # proxy context only has the plain submit path.
        submit_method = getattr(worker, "submit_actor_method", None)
        if submit_method is not None:
            submit_method(spec)
        else:
            worker.submit(spec)
        refs = [ObjectRef(oid) for oid in return_ids]
        for oid in return_ids:
            ref_tracker.annotate(oid, kind="actor_return")
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:8]})"


class ActorClass:
    def __init__(self, cls, options: Optional[dict] = None):
        self._cls = cls
        self._options = options or {}
        self.__name__ = getattr(cls, "__name__", "Actor")

    def options(self, **actor_options) -> "ActorClass":
        merged = dict(self._options)
        merged.update(actor_options)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        worker = global_worker()
        opts = self._options
        fn_id = worker.register_function(self._cls)
        actor_id = ids.new_actor_id()
        task_id = ids.new_task_id()
        spec = TaskSpec(
            task_id=task_id,
            kind=ACTOR_CREATION,
            fn_id=fn_id,
            args_blob=cloudpickle.dumps((list(args), dict(kwargs))),
            return_ids=[ids.object_id_for_return(task_id, 0)],
            resources=resolve_resources(opts, default_num_cpus=0),
            actor_id=actor_id,
            name=self.__name__,
            max_restarts=opts.get("max_restarts", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            actor_name=opts.get("name"),
            runtime_env=package_runtime_env(
                opts.get("runtime_env"), worker),
            **strategy_fields(opts),
        )
        tracing.attach_trace(spec)
        worker.submit(spec)
        return ActorHandle(actor_id, self.__name__)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self.__name__!r} cannot be instantiated directly; "
            f"use {self.__name__}.remote()."
        )
