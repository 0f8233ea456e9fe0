"""Worker process entry point.

Counterpart of the reference worker main loop
(Ray's python/ray/_private/worker.py:953 ``main_loop`` + the task
execution callback in python/ray/_raylet.pyx:2295): connects to the node's
scheduler and object store, registers, then executes task messages —
deserializing args (resolving top-level ObjectRefs from the store), running
the user function or actor method, and writing returns back to shared memory.
Actors with ``max_concurrency > 1`` run methods on a thread pool; everything
else is sequential in arrival order, which preserves actor call ordering.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import cloudpickle

from ray_tpu_torch._private import profiling
from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import runtime_env as runtime_env_mod
from ray_tpu_torch._private.task_spec import (
    ACTOR_CREATION,
    ACTOR_METHOD,
    TASK,
    TaskSpec,
    is_plain_task,
)
from ray_tpu_torch._private.serialization import store_error_best_effort
from ray_tpu_torch._private.worker import WorkerContext, set_global_worker
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.store_client import StoreClient
from ray_tpu_torch.util import tracing


class WorkerRuntime:
    def __init__(self, args):
        self.worker_id = bytes.fromhex(args.worker_id)
        self.store = StoreClient(args.store_socket, args.shm_name,
                                 args.store_capacity)
        self.conn = protocol.connect_addr(args.scheduler_socket)
        self.scheduler_socket = args.scheduler_socket
        self.actors: dict[bytes, object] = {}
        self.actor_pools: dict[bytes, ThreadPoolExecutor] = {}
        self.fn_cache: dict[bytes, object] = {}
        # Serializes method execution on a non-concurrent actor across the
        # two delivery paths (scheduler conn + direct server connections).
        self._actor_locks: dict[bytes, threading.Lock] = {}
        self._actor_locks_guard = threading.Lock()
        # Binary node-service frames (0x10 submit / 0x12 done / 0x13
        # sealed) engage only when the scheduler runs the native server —
        # which is exactly when this process has the extension too (same
        # image, same env; chaos disables both sides symmetrically).
        from ray_tpu_torch._private.direct import native_core

        self._native_frames = (
            native_core() is not None
            and os.environ.get("RTPU_NATIVE_RAYLET", "1") != "0")

        self.ctx = WorkerContext(
            mode="worker",
            store=self.store,
            submit_fn=self._submit,
            rpc_fn=self._rpc,
            worker_id=self.worker_id,
            block_notify_fn=lambda blocked: self.conn.send(
                {"t": "blocked" if blocked else "unblocked",
                 "task_id": self.ctx.current_task_id}),
            seal_notify_fn=self._notify_sealed,
            gcs_address=os.environ.get("RTPU_GCS_ADDRESS") or None,
        )
        set_global_worker(self.ctx)

        # Direct-call server: callers push actor methods straight to this
        # process (see _private/direct.py; native C++ transport when the
        # extension is available).  TCP clusters bind the same interface
        # as the scheduler; unix clusters use a per-worker path.
        from ray_tpu_torch._private.direct import make_direct_server

        if protocol.is_tcp_addr(args.scheduler_socket):
            host, _, _ = args.scheduler_socket.rpartition(":")
            bind = f"{host}:0"
        else:
            bind = os.path.join(
                os.path.dirname(args.store_socket),
                f"w_{self.worker_id.hex()}.sock")
        self.direct_server = make_direct_server(self, bind)
        # Caller-side direct path for actor calls made FROM this worker.
        self.ctx.init_direct(self._rpc)
        # Sampling profiler + its dedicated control channel to the
        # scheduler (profile_start/stop and live stack dumps must work
        # while the main loop is busy executing a task).
        profiling.start_worker_profiler(args.scheduler_socket,
                                        self.worker_id)

    def _submit(self, spec: TaskSpec) -> None:
        """Nested-task submission: plain tasks ride the binary raylet
        lane (consumed in C++ on the scheduler; Python only when the lane
        is off), everything else the pickled policy path."""
        if self._native_frames and is_plain_task(spec):
            import pickle
            import struct

            spec.retries_left = spec.max_retries
            tid = spec.task_id
            cpu = float((spec.resources or {}).get("CPU", 0))
            name = (spec.name or "").encode("utf-8")[:255]
            # never split a UTF-8 codepoint mid-sequence
            name = name.decode("utf-8", "ignore").encode("utf-8")
            self.conn.send_bytes(
                bytes([0x10, len(tid)]) + tid + struct.pack("<d", cpu)
                + struct.pack("<H", len(name)) + name
                + pickle.dumps(spec, protocol=5))
        else:
            self.conn.send({"t": "submit", "spec": spec})

    def _notify_sealed(self, oid: bytes) -> None:
        if self._native_frames:
            # 0x13: buffered in the scheduler's C++ raylet, published to
            # the GCS in batches — no Python wakeup per seal
            self.conn.send_bytes(bytes([0x13, 1, len(oid)]) + oid)
        else:
            self.conn.send({"t": "sealed", "oid": oid})

    def _rpc(self, method: str, params: dict):
        if protocol.chaos_should_fail(method, "req"):
            raise ConnectionResetError(
                f"rpc chaos: injected {method} request failure")
        conn = protocol.connect_addr(self.scheduler_socket)
        try:
            conn.send({"t": "rpc", "method": method, "params": params})
            resp = conn.recv()
            if resp is not None and protocol.chaos_should_fail(
                    method, "resp"):
                raise ConnectionResetError(
                    f"rpc chaos: injected {method} response failure")
        finally:
            conn.close()
        if resp is None or not resp.get("ok"):
            raise RuntimeError(f"rpc {method} failed: "
                               f"{resp.get('error') if resp else 'closed'}")
        return resp["result"]

    def actor_lock(self, actor_id) -> threading.Lock:
        with self._actor_locks_guard:
            lock = self._actor_locks.get(actor_id)
            if lock is None:
                lock = threading.Lock()
                self._actor_locks[actor_id] = lock
            return lock

    def notify_sealed(self, oid: bytes):
        self._notify_sealed(oid)

    def run(self):
        self.conn.send({"t": "register", "worker_id": self.worker_id.hex(),
                        "server_addr": self.direct_server.addr})
        while True:
            kind, msg = self.conn.recv_any()
            if kind is None:
                return
            if kind == "raw":
                # 0x11 ASSIGN from the native raylet: [tl][tid][payload]
                frame = msg
                if frame and frame[0] == 0x11:
                    import pickle

                    tl = frame[1]
                    spec = pickle.loads(bytes(frame[2 + tl:]))
                    spec._native_lane = True  # DONE goes back as 0x12
                    self.handle_task(spec, {})
                    if getattr(self, "_retiring", False):
                        return
                continue
            t = msg["t"]
            if t == "task":
                self.handle_task(msg["spec"], msg.get("env") or {})
                if getattr(self, "_retiring", False):
                    return
            elif t == "shutdown":
                return

    def _notify_done(self, spec: TaskSpec, ok: bool, error):
        retire = self._retire_after(spec)
        if retire:
            self._retiring = True
        if getattr(spec, "_native_lane", False):
            if retire:
                # mark this worker retiring before DONE hands it back to
                # the C++ idle pool: the Python lane then never leases it,
                # and tasks the raylet assigns it meanwhile are requeued
                # unstarted when it exits
                try:
                    self._rpc("worker_retiring",
                              {"worker_id": self.worker_id})
                except Exception:  # noqa: BLE001 — DONE must still go out
                    pass
            # 0x12: consumed by the C++ raylet (resource return + next
            # dispatch) — the scheduler's Python never runs
            tid = spec.task_id
            self.conn.send_bytes(
                bytes([0x12, len(tid)]) + tid + bytes([1 if ok else 0]))
        else:
            self.conn.send({"t": "done", "task_id": spec.task_id,
                            "ok": ok, "error": error, "retire": retire})

    def _retire_after(self, spec: TaskSpec) -> bool:
        """True when this plain task left a CUDA context in the process,
        granted a GPU or not: the context is bound to the device it was
        made on, so a later grant of another index could not take effect,
        and the caching allocator would keep the task's memory.  The
        worker reports it and exits after the task (the scheduler neither
        reuses it nor counts it as a crash)."""
        if spec.kind != TASK:
            return False
        torch = sys.modules.get("torch")
        try:
            return torch is not None and torch.cuda.is_initialized()
        except Exception:
            return False

    def handle_task(self, spec: TaskSpec, env: dict):
        # Clear env granted to the previous task (CUDA_VISIBLE_DEVICES)
        # before applying this task's grant — a pooled worker must not leak
        # device visibility across tasks.  Actor methods are exempt: the
        # grant made at actor creation lives for the actor's lifetime (its
        # CUDA context may be created lazily inside any later method call).
        # A grant only takes effect before the process creates its CUDA
        # context, so a plain task that left a context behind retires its
        # worker (_retire_after): the next task gets a fresh process.
        if spec.kind != ACTOR_METHOD:
            for k in getattr(self, "_last_task_env", ()):  # noqa: B009
                if k not in env:
                    os.environ.pop(k, None)
            self._last_task_env = list(env)
            for k, v in env.items():
                os.environ[k] = v
        pool = self.actor_pools.get(spec.actor_id) if spec.actor_id else None
        if spec.kind == ACTOR_METHOD and pool is not None:
            pool.submit(self.execute, spec)
        else:
            self.execute(spec)

    def _load_function(self, fn_id: bytes):
        fn = self.fn_cache.get(fn_id)
        if fn is None:
            view = self.store.get(fn_id, 0)
            blob = None
            if view is None:
                # Cheap first stop: the persisted-GCS mirror (actor classes
                # survive head restarts there — see scheduler.submit).  On
                # a restored control plane no store anywhere holds the
                # blob, so probing the KV BEFORE the pull wait is what
                # makes actor recovery prompt.
                try:
                    blob = self.ctx.rpc("kv_get", {"namespace": "fn_blob",
                                                   "key": fn_id})
                except Exception:
                    blob = None
            if view is None and blob is None:
                # Blob lives in some node's store (spilled task): pull it.
                # RE-REQUEST while waiting — a single pull request can be
                # lost (injected RPC chaos, a peer mid-restart) and must
                # not stall the task for the whole wait window.
                import time as _time

                deadline = _time.monotonic() + 60.0
                while view is None and _time.monotonic() < deadline:
                    self.ctx.request_pull(fn_id)
                    view = self.store.get(fn_id, 2_000)
            if view is not None:
                try:
                    blob = bytes(view)
                finally:
                    self.store.release(fn_id)
            elif blob is None:
                raise RuntimeError(
                    f"function blob {fn_id.hex()[:12]} not found")
            fn = cloudpickle.loads(blob)
            self.fn_cache[fn_id] = fn
        return fn

    def _resolve_args(self, blob: bytes):
        t0 = time.perf_counter()
        try:
            args, kwargs = cloudpickle.loads(blob)
            # Ray semantics: top-level ObjectRef args are resolved to their
            # values; refs nested inside structures are passed through as
            # refs.
            args = [self.ctx.get_object(a) if isinstance(a, ObjectRef) else a
                    for a in args]
            kwargs = {k: self.ctx.get_object(v)
                      if isinstance(v, ObjectRef) else v
                      for k, v in kwargs.items()}
            return args, kwargs
        finally:
            # charge deserialization + dependency fetch to the active
            # task span's arg-fetch bucket (critical-path breakdown)
            tracing.note_arg_fetch(time.perf_counter() - t0)

    def _invoke_method(self, spec: TaskSpec):
        """Resolve args and run one actor method; returns the raw result."""
        instance = self.actors.get(spec.actor_id)
        if instance is None:
            raise RuntimeError(
                f"actor {spec.actor_id.hex()[:8]} not on this worker")
        args, kwargs = self._resolve_args(spec.args_blob)
        if spec.method_name == "__rtpu_apply__":
            # Universal hidden method (counterpart of the reference's
            # __ray_call__): run fn(actor_instance, *rest) inside the
            # actor's process — substrate for declare_collective_group
            # and device-object send/recv.
            fn = args[0]
            return fn(instance, *args[1:], **kwargs)
        return getattr(instance, spec.method_name)(*args, **kwargs)

    def run_actor_method(self, spec: TaskSpec):
        """Direct-path execution: run the method on the CALLING thread with
        task ids set thread-locally; the caller (DirectServer) owns result
        packing and actor-lock acquisition."""
        self.ctx.current_task_id = spec.task_id
        self.ctx.current_actor_id = spec.actor_id
        token = tracing.begin_task_span(spec)
        ptok = profiling.note_task(spec)
        ok = True
        try:
            return self._invoke_method(spec)
        except BaseException:
            ok = False
            raise
        finally:
            profiling.clear_task(ptok)
            tracing.end_task_span(token, ok=ok)
            self.ctx.current_task_id = None
            self.ctx.current_actor_id = None

    def store_returns(self, spec: TaskSpec, result):
        self._store_returns(spec, result)

    def _store_returns(self, spec: TaskSpec, result):
        n = len(spec.return_ids)
        if n == 0:
            return
        if spec.tensor_transport == "device" and spec.actor_id:
            # Keep the value resident in this (producing) process — a CUDA
            # tensor stays on the card — and seal only a marker per return.
            from ray_tpu_torch._private import device_objects

            values = list(result) if n > 1 else [result]
            if len(values) != n:
                raise ValueError(
                    f"task {spec.name} declared num_returns={n} but "
                    f"returned {len(values)} values")
            for oid, value in zip(spec.return_ids, values):
                device_objects.store_resident(oid, value)
                try:
                    self.ctx.put_object(
                        device_objects.DeviceObjectMarker(
                            spec.actor_id, oid),
                        oid=oid)
                except FileExistsError:
                    pass
            return
        values = (list(result) if n > 1 else [result])
        if n > 1 and len(values) != n:
            raise ValueError(
                f"task {spec.name} declared num_returns={n} but returned "
                f"{len(values)} values")
        for oid, value in zip(spec.return_ids, values):
            try:
                self.ctx.put_object(value, oid=oid)
            except FileExistsError:
                pass  # retried task; first result wins

    def execute(self, spec: TaskSpec):
        self.ctx.current_task_id = spec.task_id
        self.ctx.current_actor_id = spec.actor_id
        # Built-in execution span for traced specs: establishes the trace
        # context so nested .remote()s parent here; no-op (None) otherwise.
        token = tracing.begin_task_span(spec)
        # Profiler attribution: samples of this thread now fold under the
        # task's name (+ trace id), joining profiles up with traces.
        ptok = profiling.note_task(spec)
        ok, error = True, None
        # Runtime env: normal tasks apply/undo around execution; an actor's
        # env (applied at creation) persists for its lifetime — the worker
        # is dedicated to the actor (reference: runtime_env installed by the
        # agent before the worker starts, _private/runtime_env/).
        applied_env = None
        if spec.runtime_env and spec.kind != ACTOR_METHOD:
            try:
                applied_env = runtime_env_mod.apply(spec.runtime_env, self.ctx)
            except BaseException as e:  # noqa: BLE001
                ok, error = False, repr(e)
                tb = traceback.format_exc()
                for oid in spec.return_ids:
                    if store_error_best_effort(self.store, oid, e, tb,
                                               raised_by_task=True):
                        self._notify_sealed(oid)
                self._notify_done(spec, ok, error)
                profiling.clear_task(ptok)
                tracing.end_task_span(token, ok=False)
                self.ctx.current_task_id = None
                self.ctx.current_actor_id = None
                return
        try:
            if spec.kind == ACTOR_CREATION:
                cls = self._load_function(spec.fn_id)
                args, kwargs = self._resolve_args(spec.args_blob)
                instance = cls(*args, **kwargs)
                self.actors[spec.actor_id] = instance
                if spec.max_concurrency > 1:
                    self.actor_pools[spec.actor_id] = ThreadPoolExecutor(
                        max_workers=spec.max_concurrency)
                result = None
            elif spec.kind == ACTOR_METHOD:
                if self.actor_pools.get(spec.actor_id) is not None:
                    # concurrent actor: the pool provides the parallelism
                    result = self._invoke_method(spec)
                else:
                    # serialize against direct-path deliveries of the same
                    # actor (direct.py executes on per-connection threads)
                    with self.actor_lock(spec.actor_id):
                        result = self._invoke_method(spec)
            else:
                fn = self._load_function(spec.fn_id)
                args, kwargs = self._resolve_args(spec.args_blob)
                result = fn(*args, **kwargs)
            # Close + flush the span BEFORE sealing returns: the moment a
            # return object is visible, the caller may kill this process
            # (kill-after-result is how short-lived actors are used), and
            # a span still buffered at SIGKILL is lost from the trace.
            tracing.end_task_span(token, ok=True)
            token = None
            self._store_returns(spec, result)
        except BaseException as e:  # noqa: BLE001 - report everything upstream
            ok, error = False, repr(e)
            tb = traceback.format_exc()
            for oid in spec.return_ids:
                # raised_by_task distinguishes "this task ran and raised"
                # (even a propagated ActorDiedError from an upstream get)
                # from transport-level failures the scheduler records
                if store_error_best_effort(self.store, oid, e, tb,
                                           raised_by_task=True):
                    self._notify_sealed(oid)
                else:
                    print(f"FATAL: could not record error for "
                          f"{oid.hex()[:12]}", file=sys.stderr, flush=True)
        finally:
            # Actor envs persist only if creation SUCCEEDED — on failure the
            # scheduler returns this worker to the shared pool, which must
            # not inherit the dead actor's cwd/env/sys.path.
            if applied_env is not None and (
                spec.kind != ACTOR_CREATION or not ok
            ):
                applied_env.undo()
            profiling.clear_task(ptok)
            tracing.end_task_span(token, ok=ok)
            self.ctx.current_task_id = None
            self.ctx.current_actor_id = None
        self._notify_done(spec, ok, error)


def main():
    # `ray stack` analogue (reference: scripts.py:2683 py-spy dumps): signal
    # a worker with SIGUSR1 to dump all thread stacks to stderr.
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    p = argparse.ArgumentParser()
    p.add_argument("--scheduler-socket", required=True)
    p.add_argument("--store-socket", required=True)
    p.add_argument("--shm-name", required=True)
    p.add_argument("--store-capacity", type=int, required=True)
    p.add_argument("--worker-id", required=True)
    args = p.parse_args()
    runtime = WorkerRuntime(args)
    try:
        runtime.run()
    except KeyboardInterrupt:
        pass
    finally:
        # stop the background flushers cleanly (final best-effort push)
        # instead of leaving their loops spinning through interpreter exit
        from ray_tpu_torch.util import metrics as metrics_mod

        metrics_mod.shutdown_flusher(flush=True)
        tracing.shutdown_flusher(flush=True)
        profiling.shutdown_sampler(flush=True)
        from ray_tpu_torch._private import ref_tracker

        ref_tracker.shutdown_flusher(flush=False)  # refs die with us
        ref_tracker.clear()
    if getattr(runtime, "_retiring", False):
        # a retired worker goes now: no thread left serving calls may keep
        # its CUDA context (and the card memory it holds) alive
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    sys.exit(0)


if __name__ == "__main__":
    main()
