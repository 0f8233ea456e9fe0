"""DeploymentHandle: the client-side entry to a deployment's replicas.

Counterpart of ``ray_tpu/serve/handle.py``; that is, of the reference's
handle + router (Ray's python/ray/serve/handle.py:340 DeploymentHandle,
_private/router.py:341): a handle keeps a cached replica set (refreshed from
the controller when its version bumps) and delegates every placement
decision to the deployment's process-wide RequestRouter
(serve/request_router/) — pow-2 by default, prefix-aware for LLM
deployments. Routing state (in-flight counts, prefix tree, replica stats)
lives in the shared router, NOT per handle, so two handles to the same
deployment agree on placement. Handles are plain data (app/deployment names)
and can be pickled into other replicas for model composition.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef

CONTROLLER_NAME = "SERVE_CONTROLLER"


class DeploymentResponse:
    """Future-ish result of handle.remote() (reference: handle.py
    DeploymentResponse).  Passing a response as an argument to another
    handle call forwards the underlying ObjectRef, so the downstream
    replica resolves it from the object store without a round trip
    through the caller.
    """

    def __init__(self, ref: ObjectRef, on_done=None, retry=None):
        self._ref = ref
        self._on_done = on_done
        self._retry = retry  # () -> new ObjectRef on a fresh replica
        self._done = False

    def result(self, timeout_s: Optional[float] = None):
        from ray_tpu_torch.exceptions import (ActorDiedError, TaskError,
                                        WorkerCrashedError)

        attempts = 3
        try:
            while True:
                try:
                    return ray_tpu_torch.get(self._ref, timeout=timeout_s)
                except (ActorDiedError, WorkerCrashedError) as e:
                    # Routed from a stale cache to a dead replica: fail
                    # over to a live one (reference: router retries on
                    # replica death).  A TaskError dual means the replica
                    # is alive and its code re-raised an upstream system
                    # error (e.g. get on a dead composed deployment) —
                    # re-executing on another replica can't help and may
                    # duplicate side effects.
                    if isinstance(e, TaskError):
                        raise
                    attempts -= 1
                    if self._retry is None or attempts <= 0:
                        raise
                    self._ref = self._retry()
        finally:
            self._settle()

    def _to_object_ref(self) -> ObjectRef:
        self._settle()
        return self._ref

    def _settle(self):
        if not self._done and self._on_done is not None:
            self._done = True
            self._on_done()

    def __del__(self):
        # Fire-and-forget callers never invoke result(); settle on GC so
        # the handle's per-replica in-flight counters don't skew routing.
        try:
            self._settle()
        except Exception:
            pass


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._call(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(self, app_name: str, deployment_name: str):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self._version = -1
        self._lock = threading.Lock()
        self._last_refresh = 0.0
        self._router: Optional[Any] = None  # bound on first refresh (the
        # policy comes from the controller with the replica set)

    # -- replica set maintenance -----------------------------------------

    def _controller(self):
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)

    def _refresh(self, force: bool = False):
        from ray_tpu_torch.serve.request_router import get_router

        now = time.monotonic()
        with self._lock:
            router = self._router
            if (router is not None and router.replicas() and not force
                    and now - self._last_refresh < 1.0):
                return
        info = ray_tpu_torch.get(self._controller().get_replicas.remote(
            self.app_name, self.deployment_name))
        router = get_router(self.app_name, self.deployment_name,
                            info.get("policy") or "pow2")
        router.update_replicas(info["replicas"])
        router.update_stats(info.get("stats") or {})
        # replicas the controller saw DIE (vs scale down): purge their
        # stats / prefix-tree homes NOW instead of letting a stale digest
        # pin a dead home until RTPU_ROUTER_STALE_S expires
        router.purge_dead(info.get("dead") or [])
        with self._lock:
            self._router = router
            self._version = info["version"]
            self._last_refresh = now

    # -- routing ----------------------------------------------------------

    def _choose(self, hint: Optional[str] = None):
        """Delegate to the deployment's shared RequestRouter (pow-2 or
        prefix-aware per DeploymentConfig.request_router_policy).  The
        router object is process-wide — every handle to this deployment
        routes against the SAME in-flight counts and prefix tree."""
        router = self._router
        if router is None:
            raise RuntimeError(
                f"deployment {self.deployment_name} has no running replicas")
        return router.choose(hint)

    def _call(self, method: str, args, kwargs,
              hint: Optional[str] = None) -> DeploymentResponse:
        # The serve.route span covers the routing decision + submission
        # (not the result wait): inside a traced request the replica's
        # handle_request task span parents under it via attach_trace, so
        # the tree reads router decision -> replica -> engine.
        from ray_tpu_torch.util import tracing

        with tracing.trace_span(
                "serve.route", app=self.app_name,
                deployment=self.deployment_name, method=method,
                hinted=hint is not None) as sp:
            return self._routed_call(method, args, kwargs, hint, sp)

    def _routed_call(self, method: str, args, kwargs,
                     hint: Optional[str], sp) -> DeploymentResponse:
        deadline = time.monotonic() + 30.0
        reported = False
        while True:
            self._refresh()
            try:
                replica = self._choose(hint)
                break
            except RuntimeError:
                if time.monotonic() > deadline:
                    raise
                if not reported:
                    # scale-from-zero signal (reference: handles push queue
                    # metrics to the controller's autoscaling state)
                    try:
                        self._controller().report_no_replica.remote(
                            self.app_name, self.deployment_name, 1)
                    except Exception:
                        pass
                    reported = True
                time.sleep(0.2)
                self._refresh(force=True)
        # unwrap DeploymentResponses into raw refs (composition fast path)
        args = tuple(a._to_object_ref()
                     if isinstance(a, DeploymentResponse) else a
                     for a in args)
        kwargs = {k: (v._to_object_ref()
                      if isinstance(v, DeploymentResponse) else v)
                  for k, v in kwargs.items()}
        rid = replica.actor_id
        state = {"rid": rid}
        router = self._router
        router.on_send(rid)
        if sp is not None:
            try:
                loads = [router.load(r.actor_id)
                         for r in router.replicas()]
                sp.attrs.update(
                    policy=router.policy,
                    outcome=getattr(router, "_last_outcome", None),
                    replica=rid.hex()[:12] if isinstance(rid, bytes)
                    else str(rid),
                    replicas=len(loads),
                    imbalance=(max(loads) - min(loads)) if loads else 0)
            except Exception:
                pass

        def done():
            router.on_done(state["rid"])

        def retry():
            # Failover must WAIT for the controller to notice the death and
            # start a replacement (its reconcile tick is ~100ms; a replica
            # restart takes seconds) — an immediate re-pick would just find
            # the same dead replica in the cache and burn all attempts in
            # microseconds.
            deadline = time.monotonic() + 15.0
            while True:
                self._refresh(force=True)
                try:
                    rep = self._choose()
                except RuntimeError:
                    rep = None
                if rep is not None and rep.actor_id != state["rid"]:
                    # move the in-flight accounting to the new replica so
                    # pow-2 routing sees the failed-over load
                    router.move(state["rid"], rep.actor_id)
                    state["rid"] = rep.actor_id
                    return rep.handle_request.remote(method, args, kwargs)
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"deployment {self.deployment_name}: no replacement "
                        f"replica appeared for failover")
                time.sleep(0.25)

        ref = replica.handle_request.remote(method, args, kwargs)
        return DeploymentResponse(ref, on_done=done, retry=retry)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._call("__call__", args, kwargs)

    def options(self, *, routing_hint: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                **_ignored) -> "DeploymentHandle":
        if routing_hint is not None or multiplexed_model_id is not None:
            return _HintedHandle(self, routing_hint, multiplexed_model_id)
        return self

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def __reduce__(self):
        return (DeploymentHandle, (self.app_name, self.deployment_name))

    def __repr__(self):
        return (f"DeploymentHandle(app={self.app_name!r}, "
                f"deployment={self.deployment_name!r})")


class _HintedHandle:
    """handle.options(routing_hint=... / multiplexed_model_id=...): same
    call surface, affinity routing; model id travels to the replica so
    serve.get_multiplexed_model_id() sees it (reference: multiplexed
    model routing, serve/_private/replica.py request context)."""

    def __init__(self, base: DeploymentHandle, hint: Optional[str],
                 model_id: Optional[str]):
        self._base = base
        self._hint = hint if hint is not None else model_id
        self._model_id = model_id

    def _call(self, method: str, args, kwargs) -> DeploymentResponse:
        if self._model_id is not None:
            kwargs = dict(kwargs)
            kwargs["__multiplexed_model_id"] = self._model_id
        return self._base._call(method, args, kwargs, hint=self._hint)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._call("__call__", args, kwargs)

    def options(self, **kw):
        merged = {"routing_hint": self._hint,
                  "multiplexed_model_id": self._model_id}
        merged.update(kw)
        return self._base.options(**merged)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)
