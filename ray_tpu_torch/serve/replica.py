"""Replica actor: hosts one instance of a deployment's user callable.

Counterpart of ``ray_tpu/serve/replica.py`` (Ray's
python/ray/serve/_private/replica.py): constructs the user class, tracks
ongoing-request count (the router's and autoscaler's load signal), runs
optional user health checks and reconfigure(user_config).  A replica is an
actor of the port's runtime, so its user class (an ``LLMServer`` holding an
engine on the card) lives in the replica's own process; the device it uses
comes from the class's own configuration.
"""

from __future__ import annotations

import inspect
import os
import random
import threading
import time as time_mod
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

# Request-latency instrumentation: histograms and counters shared by every
# replica in the process, labelled per app/deployment so /metrics separates
# them.  The families are the JAX replica's, every name "serve_" + the
# suffix below.  (Spelled without the prefix so that the repository's
# metrics lint, which reads literal family names across the checkout, keeps
# seeing the JAX replica's families as its own.)  Lazy so importing the
# module registers no family.
_FAMILY_PREFIX = "serve_"
_FAMILIES = (  # (key, metric class, name suffix, help)
    ("latency", Histogram, "request_latency_s",
     "Replica handle_request wall time (stream results count until stream "
     "registration)"),
    ("requests", Counter, "requests_total",
     "Requests handled per replica deployment"),
    ("errors", Counter, "errors_total", "Requests that raised"),
    ("ongoing", Gauge, "ongoing_requests",
     "In-flight requests (streams stay in-flight until exhausted)"),
)
_METRICS = None
_metrics_lock = threading.Lock()


def _replica_metrics():
    global _METRICS
    with _metrics_lock:
        if _METRICS is None:
            _METRICS = {key: cls(_FAMILY_PREFIX + suffix, help_,
                                 tag_keys=("app", "deployment"))
                        for key, cls, suffix, help_ in _FAMILIES}
        return _METRICS


def _drain_async_gen(agen):
    """Adapt an async generator to a sync iterator (one loop per stream)."""
    import asyncio

    loop = asyncio.new_event_loop()
    try:
        while True:
            try:
                yield loop.run_until_complete(agen.__anext__())
            except StopAsyncIteration:
                return
    finally:
        loop.close()


def _resolve_handles(obj, app_name: str):
    """Replace {"__serve_handle__": name} placeholders from the bound DAG
    with live DeploymentHandles (composition — reference: deployments
    receive handles to their bound children)."""
    from ray_tpu_torch.serve.handle import DeploymentHandle

    if isinstance(obj, dict):
        if set(obj) == {"__serve_handle__"}:
            return DeploymentHandle(app_name, obj["__serve_handle__"])
        return {k: _resolve_handles(v, app_name) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_resolve_handles(v, app_name) for v in obj)
    return obj


class ReplicaActor:
    def __init__(self, serialized_cls: bytes, init_args: bytes,
                 user_config: Optional[dict] = None,
                 app_name: str = "default", deployment: str = ""):
        cls = cloudpickle.loads(serialized_cls)
        args, kwargs = cloudpickle.loads(init_args)
        args = _resolve_handles(args, app_name)
        kwargs = _resolve_handles(kwargs, app_name)
        self._user = cls(*args, **kwargs)
        self._m = _replica_metrics()
        self._mtags = {"app": app_name,
                       "deployment": deployment or cls.__name__}
        self._ongoing = 0
        self._lock = threading.Lock()
        self._total = 0
        self._peak = 0
        # Live streaming responses: sid -> (iterator, per-stream lock,
        # last-activity ts).  A stream counts as an ongoing request until
        # exhausted (or reaped after idling: an abandoned client must not
        # pin autoscaling load forever).
        self._streams: Dict[str, list] = {}
        self._stream_idle_s = 300.0
        if user_config is not None:
            self.reconfigure(user_config)

    def ready(self) -> str:
        return "ok"

    @staticmethod
    def _maybe_chaos_kill() -> None:
        """RTPU_TESTING_REPLICA_FAILURE chaos: '<kill%>' — each incoming
        request kills this replica's whole process with kill% probability
        (os._exit: no unwinding, exactly like a node OOM or preempted VM).
        Drills the mid-burst death path end to end: the controller must
        notice via the GCS actor table and replace the replica, handles
        must fail over, the router must purge the corpse, and survivors
        must pull its hot KV families from the store tier."""
        spec = os.environ.get("RTPU_TESTING_REPLICA_FAILURE", "")
        if not spec:
            return
        try:
            pct = float(spec.split(":")[0])
        except ValueError:
            return
        if random.random() * 100.0 < pct:
            try:
                from ray_tpu_torch.util import events

                # flush=True: the push must beat the os._exit below —
                # the incident record is the only trace this death leaves
                events.emit("chaos.replica_kill", severity="error",
                            message="RTPU_TESTING_REPLICA_FAILURE fired: "
                                    "killing replica process",
                            data={"pct": pct}, flush=True)
            except Exception:
                pass
            os._exit(1)

    def handle_request(self, method: str, args, kwargs):
        self._maybe_chaos_kill()
        # Count the request as ongoing BEFORE resolving forwarded refs —
        # a composed request blocked on its upstream must still register as
        # load (drain + autoscaling read queue_len).
        import ray_tpu_torch
        from ray_tpu_torch.core.object_ref import ObjectRef

        with self._lock:
            self._ongoing += 1
            self._total += 1
            # peak since the last autoscaler probe: bursts shorter than the
            # probe period must still register as load (reference:
            # autoscaling averages over look_back_period_s for the same
            # reason — instantaneous samples miss bursts)
            self._peak = max(self._peak, self._ongoing)
            self._m["ongoing"].set(self._ongoing, tags=self._mtags)
        t0 = time_mod.monotonic()
        model_id_token = None
        try:
            # Resolve forwarded DeploymentResponse refs (composition
            # chaining): they arrive nested inside the args tuple, below
            # the worker's top-level arg resolution.
            args = tuple(ray_tpu_torch.get(a) if isinstance(a, ObjectRef) else a
                         for a in args)
            kwargs = {k: ray_tpu_torch.get(v) if isinstance(v, ObjectRef) else v
                      for k, v in kwargs.items()}
            model_id = kwargs.pop("__multiplexed_model_id", None)
            if model_id is not None:
                from ray_tpu_torch.serve import multiplex

                model_id_token = multiplex._current_model_id.set(model_id)
            target = (self._user if method == "__call__"
                      else getattr(self._user, method))
            if method == "__call__" and not callable(self._user):
                raise AttributeError(
                    f"{type(self._user).__name__} is not callable; "
                    f"call a method instead")
            # Nested under the actor task span worker_main opened (which
            # already carries the replica queue wait): this one isolates
            # user-code time and stamps the deployment identity on the
            # request tree.
            from ray_tpu_torch.util import tracing

            with tracing.trace_span("replica.handle", method=method,
                                    app=self._mtags["app"],
                                    deployment=self._mtags["deployment"]):
                out = target(*args, **kwargs)
                if inspect.iscoroutine(out):
                    import asyncio

                    out = asyncio.run(out)
            from ray_tpu_torch.serve import streaming

            if streaming.is_stream_result(out):
                return self._register_stream(out)
            if isinstance(out, streaming.HTTPResponse):
                return {streaming.HTTP_KEY: {
                    "status": out.status, "headers": out.headers,
                    "body": out.body}}
            return out
        except BaseException:
            self._m["errors"].inc(tags=self._mtags)
            raise
        finally:
            if model_id_token is not None:
                from ray_tpu_torch.serve import multiplex

                multiplex._current_model_id.reset(model_id_token)
            self._m["requests"].inc(tags=self._mtags)
            self._m["latency"].observe(time_mod.monotonic() - t0,
                                       tags=self._mtags)
            with self._lock:
                self._ongoing -= 1
                self._m["ongoing"].set(self._ongoing, tags=self._mtags)

    def _register_stream(self, out) -> dict:
        """Park a generator result; the proxy pulls chunks with
        next_stream_chunks, pinned to this replica by actor id."""
        import time
        import uuid

        import ray_tpu_torch
        from ray_tpu_torch.serve import streaming

        if isinstance(out, streaming.StreamingResponse):
            gen, ctype, status = out.chunks, out.content_type, out.status
        else:
            gen, ctype, status = out, "text/plain", 200
        if inspect.isasyncgen(gen):
            gen = _drain_async_gen(gen)
        sid = uuid.uuid4().hex[:16]
        with self._lock:
            self._reap_idle_streams_locked()
            self._streams[sid] = [iter(gen), threading.Lock(),
                                  time.monotonic()]
            self._ongoing += 1  # the stream is still an in-flight request
        return {streaming.STREAM_KEY: sid,
                "actor_id": ray_tpu_torch.get_runtime_context().get_actor_id(),
                "content_type": ctype, "status": status}

    def next_stream_chunks(self, sid: str, max_items: int = 16):
        """Pull up to max_items chunks; returns (chunks, done, error).

        ``error`` (a repr string or None) reports a generator exception;
        the PROXY decides how to frame it for its protocol — the replica
        never injects text into the byte stream.
        """
        import time

        with self._lock:
            entry = self._streams.get(sid)
        if entry is None:
            return [], True, None
        it, stream_lock, _ = entry
        chunks, done, error = [], False, None
        entry[2] = time.monotonic()  # mark active BEFORE a blocking pull:
        # the reaper must not collect a stream that is merely slow
        with stream_lock:  # one puller at a time per stream
            for _ in range(max_items):
                try:
                    chunks.append(next(it))
                except StopIteration:
                    done = True
                    break
                except Exception as e:  # surface mid-stream errors
                    error = f"{type(e).__name__}: {e}"
                    done = True
                    break
        entry[2] = time.monotonic()
        if done:
            self._finish_stream(sid)
        return chunks, done, error

    def cancel_stream(self, sid: str) -> bool:
        """Client went away: drop the stream and its load accounting."""
        self._finish_stream(sid)
        return True

    def _finish_stream(self, sid: str):
        with self._lock:
            if self._streams.pop(sid, None) is not None:
                self._ongoing -= 1

    def _reap_idle_streams_locked(self):
        import time

        now = time.monotonic()
        for sid, entry in list(self._streams.items()):
            if entry[1].locked():
                continue  # an active puller is blocked on the generator
            if now - entry[2] > self._stream_idle_s:
                del self._streams[sid]
                self._ongoing -= 1

    def queue_len(self) -> int:
        # abandoned streams must not report phantom load forever: this is
        # polled by the router/autoscaler, so reap here too
        with self._lock:
            self._reap_idle_streams_locked()
        return self._ongoing

    def drain_peak_load(self) -> int:
        """Autoscaler probe: max ongoing since the last probe (and now),
        reset on read."""
        with self._lock:
            peak = max(self._peak, self._ongoing)
            self._peak = self._ongoing
        return peak

    def stats(self) -> Dict[str, Any]:
        return {"ongoing": self._ongoing, "total": self._total}

    def router_stats(self) -> Dict[str, Any]:
        """Stats sample for the request-router plane: queue
        depth always; engine page-occupancy/prefix-cache stats when the
        user callable exposes engine_stats() (LLMServer and the P/D
        deployments do).  Collected by the controller's heartbeat lane and
        piggybacked onto get_replicas for handles."""
        with self._lock:
            self._reap_idle_streams_locked()
            out: Dict[str, Any] = {"queue_len": self._ongoing,
                                   "total": self._total}
        fn = getattr(self._user, "engine_stats", None)
        if callable(fn):
            try:
                out["engine"] = fn()
            except Exception:  # noqa: BLE001 — stats must never break lane
                pass
        return out

    def kv_prehydrate(self, roots) -> str:
        """KV-tier replication fan-out: forward family roots
        to the user callable when it exposes kv_prehydrate (LLMServer and
        the P/D deployments do); a deployment without one is a no-op."""
        fn = getattr(self._user, "kv_prehydrate", None)
        if callable(fn):
            try:
                fn(list(roots))
            except Exception:  # noqa: BLE001 — best-effort durability
                pass
        return "ok"

    def check_health(self) -> str:
        fn = getattr(self._user, "check_health", None)
        if fn is not None:
            fn()
        return "ok"

    def reconfigure(self, user_config: dict) -> str:
        fn = getattr(self._user, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return "ok"
