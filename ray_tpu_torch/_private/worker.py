"""Process-local runtime context shared by driver and workers.

Counterpart of the reference core worker
(Ray's src/ray/core_worker/core_worker.h:166 and
python/ray/_private/worker.py): every process participating in a cluster —
the driver and each pooled worker — holds one ``WorkerContext`` wiring the
shared-memory store client and the control-plane path (direct calls in the
driver; socket messages in workers).  ``ray_tpu_torch.get/put/remote`` route through
the current global context, so user code behaves identically in both.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Callable, Optional

import cloudpickle

from ray_tpu_torch._private import ids
from ray_tpu_torch._private import ref_tracker
from ray_tpu_torch._private.serialization import (
    deserialize, is_device_token, payload_parts, serialized_size,
    write_payload)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.store_client import ObjectEvictedError, StoreClient
from ray_tpu_torch.exceptions import GetTimeoutError, ObjectLostError

_GET_CHUNK_MS = int(os.environ.get("RTPU_GET_CHUNK_MS", 500))  # blocking-get slice so Ctrl-C stays responsive
_EAGER_DELETE_MIN = int(os.environ.get("RTPU_EAGER_DELETE_MIN", 64 * 1024))
# Puts at or below this serialize into a scratch buffer and ride the
# store's one-round-trip OP_PUT instead of create/write/seal (see
# store_client.py put); the extra copy is trivial next to the saved
# daemon round trip.
_INLINE_PUT_MAX = int(os.environ.get("RTPU_INLINE_PUT_MAX", 64 * 1024))
# how often a blocked get re-requests the cross-node pull
_PULL_RETRY_S = float(os.environ.get("RTPU_PULL_RETRY_S", 2.0))
# grace before a blocking wait notifies the scheduler (sub-ms
# replies skip the notification round trip entirely)
_BLOCK_GRACE_S = float(os.environ.get("RTPU_BLOCK_GRACE_S", 0.005))
# owner-side lineage cap: oldest specs evicted past this
_LINEAGE_MAX_BYTES = int(
    os.environ.get("RTPU_LINEAGE_MAX_BYTES", 64 << 20))


class WorkerContext:
    def __init__(
        self,
        mode: str,  # "driver" | "worker"
        store: StoreClient,
        submit_fn: Callable,  # (TaskSpec) -> None
        rpc_fn: Callable,  # (method, params) -> result
        worker_id: bytes = b"",
        node=None,
        block_notify_fn: Optional[Callable] = None,
        seal_notify_fn: Optional[Callable] = None,
        gcs_address: Optional[str] = None,
    ):
        self.mode = mode
        self.store = store
        self.submit = submit_fn
        self.rpc = rpc_fn
        self.worker_id = worker_id
        self.node = node
        # GCS endpoint for pubsub subscriptions (event-driven waits); falls
        # back to RPC polling through the scheduler when absent.
        self.gcs_address = gcs_address
        # Called with the oid after each local seal so the scheduler can
        # publish the object's location to the GCS directory (multi-node
        # pulls); None in single-purpose contexts that never share objects.
        self._seal_notify = seal_notify_fn
        # Called with True/False around blocking waits so the scheduler can
        # release/re-acquire this worker's resource grant — prevents
        # dependency-chain deadlocks on small nodes.
        self._block_notify = block_notify_fn
        # Thread-local: concurrent actor methods (max_concurrency > 1) each
        # run on their own pool thread and must see their own task id.
        self._tls = threading.local()
        # id(fn) -> (fn, object-id). The strong reference to fn is load-
        # bearing: without it a GC'd function's address can be reused by a
        # new function, which would then resolve to the stale blob.
        self._fn_cache: dict[int, tuple[object, bytes]] = {}
        # Direct actor-call path (set up by init_direct): in-process memory
        # store for inline results + per-actor direct channels.
        self.memstore = None
        self._direct = None
        # actor_id -> return oids of scheduler-path method calls not yet
        # observed complete; the direct path engages only once drained so
        # the path switch can never reorder a caller's method stream.
        self._fallback_pending: dict[bytes, list[bytes]] = {}
        self._fallback_lock = threading.Lock()
        # Lineage: return oid -> producing TaskSpec, recorded at submission
        # (owner side), so a lost object can be re-created by re-executing
        # its task — reference: TaskManager lineage + ObjectRecoveryManager
        # (src/ray/core_worker/task_manager.h:175,
        # object_recovery_manager.h:43).  Bounded by entries and bytes.
        self._lineage: "dict[bytes, object]" = {}
        self._lineage_order: list[bytes] = []
        self._lineage_bytes = 0
        self._lineage_lock = threading.Lock()
        self._recon_left: dict[bytes, int] = {}

    def init_direct(self, rpc_fn) -> None:
        """Enable the direct actor-call path (memory store + channels)."""
        from ray_tpu_torch._private import direct

        self.memstore = direct.MemoryStore(promote_cb=self._promote_payload)
        self._direct = direct.DirectClient(self.memstore, rpc_fn)
        from ray_tpu_torch.core import object_ref as object_ref_mod

        object_ref_mod.set_escape_hook(self._on_ref_escape)
        # Local ref counting: when the last live ObjectRef for an oid in
        # this process is GC'd, its memory-store entry is dropped (never
        # promoted) — small direct-call results don't pile garbage into
        # the shm store.
        self._ref_counts: dict[bytes, int] = {}
        # oids this process put() locally whose refs NEVER left it: when
        # the last local ref dies the object is unreachable cluster-wide,
        # so delete it from the shm store immediately instead of letting
        # it rot until LRU eviction — which would SPILL dead bytes to disk
        # (reference semantics: the owner's ref count going to zero frees
        # the primary copy, reference_count.cc).  Escaped refs leave the
        # set and fall back to eviction.  Only objects >= the threshold
        # delete eagerly: the delete is a store round-trip, which would
        # dominate small-put throughput, and a small dead object costs
        # little to carry until LRU.
        self._owned_puts: dict[bytes, int] = {}
        # RLock: __del__ hooks can fire via GC while this thread is inside
        # _on_ref_created holding the lock.
        self._ref_lock = threading.RLock()
        object_ref_mod.set_lifecycle_hooks(self._on_ref_created,
                                           self._on_ref_deleted)
        # Reference-table telemetry: periodic refs_push snapshots feed the
        # cluster memory view (`rtpu memory` / state.list_objects).
        ref_tracker.ensure_flusher()

    def _on_ref_created(self, oid: bytes) -> None:
        with self._ref_lock:
            n = self._ref_counts.get(oid, 0) + 1
            self._ref_counts[oid] = n
        if n == 1:
            ref_tracker.note_created(oid)

    def _on_ref_deleted(self, oid: bytes) -> None:
        with self._ref_lock:
            n = self._ref_counts.get(oid, 0) - 1
            if n > 0:
                self._ref_counts[oid] = n
                return
            self._ref_counts.pop(oid, None)
            owned = self._owned_puts.pop(oid, None) is not None
        ref_tracker.note_deleted(oid)
        ms = self.memstore
        if ms is not None:
            ms.discard(oid)
        if owned:
            try:
                self.store.delete(oid)
            except Exception:
                pass  # interpreter shutdown / store already gone

    def _promote_payload(self, oid: bytes, payload: bytes) -> None:
        """Copy a memory-store payload into the shm store (so other
        processes can resolve the ref) — called when a ref escapes this
        process or the memory store evicts."""
        try:
            if len(payload) <= _INLINE_PUT_MAX:
                self.store.put(oid, payload)  # one round trip
            else:
                # large promote: write into the mmap directly (no extra
                # socket copy of a multi-MB payload)
                buf = self.store.create(oid, len(payload))
                try:
                    buf[:len(payload)] = payload
                finally:
                    buf.release()
                self.store.seal(oid)
        except FileExistsError:
            return  # already in the store
        except Exception:
            return
        if self._seal_notify is not None:
            self._seal_notify(oid)

    def collect_escaped_refs(self):
        """Context manager: collect the oids of every ObjectRef pickled on
        THIS thread inside the block (the escape hook fires per ref during
        args pickling) — how task submission learns its dependencies
        without a second pass over the args."""
        import contextlib

        @contextlib.contextmanager
        def _cm():
            prev = getattr(self._tls, "escape_sink", None)
            sink: list[bytes] = []
            self._tls.escape_sink = sink
            try:
                yield sink
            finally:
                self._tls.escape_sink = prev

        return _cm()

    def _on_ref_escape(self, oid: bytes) -> None:
        """An ObjectRef is being pickled (it may leave this process): if its
        value lives only in the in-process memory store, promote it to the
        shm store so any receiver can resolve it.  A still-pending entry is
        flagged instead — the delivery path promotes it the moment the
        direct reply lands (another process may already be blocking on the
        shm store for it)."""
        sink = getattr(self._tls, "escape_sink", None)
        if sink is not None:
            sink.append(oid)
        ref_tracker.annotate(oid, escaped=True)
        owned = getattr(self, "_owned_puts", None)
        if owned is not None:
            owned.pop(oid, None)  # other processes may now hold refs
        ms = self.memstore
        if ms is None:
            return
        payload = ms.mark_escaped(oid)
        if payload is not None:
            self._promote_payload(oid, payload)

    @property
    def current_task_id(self) -> Optional[bytes]:
        return getattr(self._tls, "task_id", None)

    @current_task_id.setter
    def current_task_id(self, value: Optional[bytes]):
        self._tls.task_id = value

    @property
    def current_actor_id(self) -> Optional[bytes]:
        return getattr(self._tls, "actor_id", None)

    @current_actor_id.setter
    def current_actor_id(self, value: Optional[bytes]):
        self._tls.actor_id = value

    # -- actor calls --------------------------------------------------------
    def actor_fastlane(self, actor_id: bytes, method_name: str,
                       label: str):
        """A fused per-(actor, method) submit closure for the hot path, or
        None when this context can't serve one.  Returns-None-per-call
        means "take the slow path" (channel missing/dead, or a scheduler-
        path fallback is still draining — the unlocked read of
        _fallback_pending is exact for the submitting thread itself, which
        is the ordering the per-caller FIFO guarantee covers).

        Counterpart of the reference's direct actor submit fast path
        (ActorTaskSubmitter caching the RPC client per handle,
        core_worker.cc SubmitActorTask): the layers ActorMethod.remote →
        _submit_method → submit_actor_method → DirectClient.submit →
        channel.call collapse into one frame over the cached channel."""
        direct = self._direct
        if direct is None:
            return None
        from ray_tpu_torch._private.direct import _fast_method_spec
        from ray_tpu_torch.core.actor import dumps_args
        from ray_tpu_torch.core.object_ref import ObjectRef as _Ref
        from ray_tpu_torch.util.tracing import attach_trace

        channels = direct._channels
        pending = self._fallback_pending
        new_task_id = ids.new_task_id
        suffix = struct.pack("<I", 0)

        def fast(args, kwargs):
            if pending.get(actor_id):
                return None
            chan = channels.get(actor_id)
            if chan is None or chan.dead:
                return None
            blob = dumps_args((list(args), dict(kwargs)))
            tid = new_task_id()
            rid = tid + suffix
            spec = _fast_method_spec(tid, rid, actor_id, method_name, blob)
            spec.name = label
            attach_trace(spec)
            if not chan.call(spec):
                return None
            return _Ref(rid)

        return fast

    def submit_actor_method(self, spec) -> None:
        """Submit an actor method: direct push when the actor is ALIVE and
        this caller has no scheduler-path calls still in flight to it
        (the drain rule keeps the per-caller order across the path
        switch); otherwise the scheduler path."""
        direct = self._direct
        aid = spec.actor_id
        if direct is not None:
            with self._fallback_lock:
                pend = self._fallback_pending.get(aid)
                if pend:
                    # drop entries whose result (value or error) is sealed —
                    # those calls finished executing
                    pend = [o for o in pend if not self._result_sealed(o)]
                    if pend:
                        self._fallback_pending[aid] = pend
                    else:
                        del self._fallback_pending[aid]
                drained = not pend
            if drained and direct.submit(spec):
                return
        self.submit(spec)
        if direct is not None and spec.return_ids:
            with self._fallback_lock:
                self._fallback_pending.setdefault(aid, []).append(
                    spec.return_ids[0])
                # bound the bookkeeping under pathological no-get workloads
                if len(self._fallback_pending[aid]) > 512:
                    self._fallback_pending[aid] = [
                        o for o in self._fallback_pending[aid]
                        if not self._result_sealed(o)][-512:]

    def _result_sealed(self, oid: bytes) -> bool:
        """Has a scheduler-path call's result (value or error) sealed
        ANYWHERE?  Cross-node actors seal on their own node, so a local
        store miss falls through to the location directory."""
        if self.store.contains(oid):
            return True
        try:
            return bool(self.rpc("object_locations", {"oid": oid}))
        except Exception:
            return False

    # -- lineage ------------------------------------------------------------
    def record_lineage(self, spec) -> None:
        """Remember the producing spec for each return oid (task outputs
        only; puts are not reconstructable, matching the reference)."""
        cost = len(spec.args_blob) + 256  # accounted PER return oid
        with self._lineage_lock:
            for oid in spec.return_ids:
                if oid not in self._lineage:
                    self._lineage_order.append(oid)
                    self._lineage_bytes += cost
                self._lineage[oid] = spec
            while (self._lineage_bytes > _LINEAGE_MAX_BYTES
                   or len(self._lineage_order) > 100_000):
                old = self._lineage_order.pop(0)
                dropped = self._lineage.pop(old, None)
                if dropped is not None:
                    self._lineage_bytes -= len(dropped.args_blob) + 256

    def _maybe_reconstruct(self, oid: bytes) -> bool:
        """Re-execute the producing task of a lost object; True if a
        resubmission happened (the caller should keep waiting)."""
        import copy

        with self._lineage_lock:
            spec = self._lineage.get(oid)
            if spec is None:
                return False
            left = self._recon_left.get(
                oid, int(os.environ.get("RTPU_MAX_RECONSTRUCTIONS", 3)))
            if left <= 0:
                return False
            self._recon_left[oid] = left - 1
        # Clear stale state: any surviving copies of the task's returns
        # (e.g. a sealed error from a failed chain attempt) and the lost
        # tombstone, so the re-execution's writes win.
        for rid in spec.return_ids:
            try:
                self.rpc("free_object", {"oid": rid})
            except Exception:
                pass
            try:
                self.store.delete(rid)
            except Exception:
                pass
        fresh = copy.copy(spec)
        fresh.spill_count = 0
        fresh.origin_node = None
        self.submit(fresh)
        return True

    def _lost_upstream_oid(self, exc: BaseException) -> bytes:
        """If exc is (or wraps) an ObjectLostError, the lost oid."""
        from ray_tpu_torch.exceptions import ObjectLostError as _Lost

        seen = exc
        for _ in range(4):
            if isinstance(seen, _Lost) and getattr(seen, "oid", b""):
                return seen.oid
            nxt = getattr(seen, "cause", None)  # TaskError chain
            if not isinstance(nxt, BaseException):
                return b""
            seen = nxt
        return b""

    # -- objects -----------------------------------------------------------
    def put_object(self, value, oid: Optional[bytes] = None) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("passing an ObjectRef to put is not allowed")
        track_owned = oid is None and getattr(self, "_owned_puts",
                                              None) is not None
        oid = oid or ids.random_object_id()
        size, token = serialized_size(value)
        track_owned = track_owned and size >= _EAGER_DELETE_MIN
        put_parts = getattr(self.store, "put_parts", None)
        # a CUDA tensor has no host buffer to hand over: its bytes go from
        # the device straight into the store slot (create/write/seal below)
        on_device = is_device_token(token)
        if on_device:
            put_parts = None
        if size <= _INLINE_PUT_MAX and not on_device:
            # small object: serialize to a scratch buffer and ship it in
            # ONE daemon round trip (OP_PUT) — create/seal round trips
            # dominate small-put cost on a 1-core host
            scratch = bytearray(size)
            write_payload(memoryview(scratch), token)
            self.store.put(oid, scratch)
        elif put_parts is not None:
            # everything else: hand the raw buffer views to the store
            # client, which picks the wire — vectored OP_PUT below
            # RTPU_ZCOPY_PUT_MIN (daemon-side copy-in against its warm
            # mapping), direct create/write/seal into the pre-faulted
            # client mapping above it (no payload bytes on the socket)
            put_parts(oid, payload_parts(token), size)
        else:
            buf = self.store.create(oid, size)
            try:
                try:
                    write_payload(buf, token)
                finally:
                    buf.release()
                self.store.seal(oid)
            except BaseException:
                # Never leave an unsealed husk behind — it would wedge
                # every consumer blocking on this id.
                self.store.abort(oid)
                raise
        if self._seal_notify is not None:
            self._seal_notify(oid)
        if track_owned:
            with self._ref_lock:
                self._owned_puts[oid] = size  # only >= _EAGER_DELETE_MIN
        ref = ObjectRef(oid)
        ref_tracker.annotate(oid, kind="put")
        return ref

    def get_object(self, ref: ObjectRef, timeout: Optional[float] = None):
        start = time.monotonic()
        value = self.get_object_raw(ref, timeout)
        # Device-resident objects resolve transparently: pull from the
        # producing actor (host-staged; _private/device_objects.py).
        from ray_tpu_torch._private.device_objects import (
            DeviceObjectMarker,
            resolve_marker,
        )
        if isinstance(value, DeviceObjectMarker):
            remaining = (None if timeout is None
                         else max(0.0, timeout - (time.monotonic() - start)))
            return resolve_marker(value, timeout=remaining)
        return value

    def get_object_raw(self, ref: ObjectRef, timeout: Optional[float] = None):
        oid = ref.binary()
        if self.memstore is not None:
            e = self.memstore.lookup(oid)
            if e is not None:
                value = self._get_from_memstore(e, timeout)
                if value is not _MEMSTORE_FALLTHROUGH:
                    return value
        # Reconstruction loop: a lost object (node death, eviction) whose
        # producing spec this owner holds is transparently re-executed; a
        # result that RAISES a wrapped ObjectLostError means an UPSTREAM
        # dependency was lost — rebuild it, re-run this task, try again.
        # The caller's timeout bounds the WHOLE loop, not each attempt.
        # Note: stored upstream errors arrive as dynamic TaskError duals
        # that subclass ObjectLostError (serialization._as_raisable), so
        # one except arm sees both direct and wrapped losses.
        deadline = None if timeout is None else time.monotonic() + timeout
        for _ in range(8):
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                return self._get_object_inner(ref, oid, remaining)
            except ObjectEvictedError:
                if self._maybe_reconstruct(oid):
                    # The local store still holds the EVICTED tombstone the
                    # reconstruct's own delete left behind; the re-executed
                    # task's seal is what clears it (shm_store.cc: creation
                    # erases the tombstone).  WAIT it out — retrying the
                    # get immediately would see the tombstone and burn the
                    # whole reconstruction budget in microseconds.
                    self._await_recreation(oid, deadline)
                    continue
                raise ObjectLostError(
                    f"object {ref} was evicted from the object store before "
                    f"it could be fetched (store under memory pressure); "
                    f"increase object_store_memory or fetch results sooner",
                    oid=oid) from None
            except ObjectLostError as e:
                lost = (getattr(e, "oid", b"")
                        or self._lost_upstream_oid(e))
                if lost == oid and self._maybe_reconstruct(oid):
                    self._await_recreation(oid, deadline)
                    continue
                if (lost and lost != oid
                        and self._maybe_reconstruct(lost)
                        and self._maybe_reconstruct(oid)):
                    # chain rebuilt: upstream + this task re-run; wait out
                    # this task's delete-tombstone before re-reading
                    self._await_recreation(oid, deadline)
                    continue
                raise
        raise ObjectLostError(
            f"object {ref} could not be reconstructed (kept getting lost "
            f"across {8} attempts)", oid=oid)

    def _await_recreation(self, oid: bytes, deadline: Optional[float],
                          max_wait_s: float = 30.0):
        """Block until a just-reconstructed object's local EVICTED
        tombstone clears (its re-executed producer sealed a fresh copy
        somewhere — locally that shows as creation erasing the tombstone,
        remotely as the tombstone simply never being rewritten).  Bounded
        by the caller's deadline and max_wait_s; returns either way — the
        caller's next get attempt decides what the state means."""
        stop = time.monotonic() + max_wait_s
        if deadline is not None:
            stop = min(stop, deadline)
        while time.monotonic() < stop:
            try:
                view = self.store.get(oid, 0)
            except ObjectEvictedError:
                time.sleep(0.02)
                continue
            if view is not None:
                self.store.release(oid)
            return  # sealed locally, or tombstone gone (pullable/pending)
        return

    def _get_from_memstore(self, entry, timeout: Optional[float]):
        """Resolve a memory-store entry: wait for the direct reply (condvar
        wake, no store polling), deserialize inline payloads, or fall
        through when the result went to the shm store."""
        from ray_tpu_torch._private.serialization import deserialize

        if not entry.done:
            self._direct.flush_all()  # coalesced submits go out before we block
            # Short grace before declaring this worker blocked: sub-ms
            # replies (the common case) skip the scheduler notification.
            if not self.memstore.wait_done(entry, _BLOCK_GRACE_S):
                blocked = self._block_notify is not None
                if blocked:
                    self._block_notify(True)
                try:
                    if not self.memstore.wait_done(entry, timeout):
                        raise GetTimeoutError(
                            f"get timed out after {timeout}s waiting for a "
                            f"direct actor-call result")
                finally:
                    if blocked:
                        self._block_notify(False)
        if entry.in_store:
            return _MEMSTORE_FALLTHROUGH
        return deserialize(memoryview(entry.payload))

    def _store_fetch(self, oid: bytes, timeout_ms: int):
        """Fetch + deserialize from the shm store; _STORE_MISS when the
        object is not available (a stored value may BE None).  Small
        objects arrive as inline bytes (one round trip, nothing pinned);
        large ones as a pinned zero-copy view released when the
        deserialized arrays die."""
        got = self.store.get_bytes(oid, timeout_ms)
        if got is None:
            return _STORE_MISS
        if isinstance(got, memoryview):
            return deserialize(
                got, release_cb=lambda o=oid: self.store.release(o))
        return deserialize(memoryview(got))

    def _get_object_inner(self, ref, oid, timeout: Optional[float]):
        # Fast path: already sealed, no block notification needed.
        value = self._store_fetch(oid, 0)
        if value is not _STORE_MISS:
            return value
        deadline = None if timeout is None else time.monotonic() + timeout
        blocked = False
        next_pull = time.monotonic()
        try:
            while True:
                if not blocked and self._block_notify is not None:
                    self._block_notify(True)
                    blocked = True
                if time.monotonic() >= next_pull:
                    # object may live on another node: ask the local
                    # scheduler to pull it.  The pull exits immediately if
                    # the object isn't sealed anywhere yet, so re-request
                    # periodically for as long as we keep waiting.
                    next_pull = time.monotonic() + _PULL_RETRY_S
                    self.request_pull(oid)
                    # every copy may have died with its node: surface LOST
                    # instead of waiting forever (the owner's get loop
                    # re-executes lineage; non-owners propagate the error)
                    try:
                        lost = self.rpc("object_lost", {"oid": oid})
                    except Exception:
                        lost = False
                    if lost and not self.store.contains(oid):
                        raise ObjectLostError(
                            f"object {ref} was lost: every node holding a "
                            f"copy died", oid=oid)
                value = self._store_fetch(oid, _GET_CHUNK_MS)
                if value is not _STORE_MISS:
                    return value
                if deadline is not None and time.monotonic() >= deadline:
                    raise GetTimeoutError(
                        f"get timed out after {timeout}s waiting for {ref}"
                    )
        finally:
            if blocked:
                self._block_notify(False)

    def request_pull(self, oid: bytes):
        try:
            self.rpc("pull", {"oid": oid})
        except Exception:
            pass  # pulls are best-effort; the caller keeps polling

    def _has_local(self, oid: bytes) -> bool:
        """Sealed locally: inline in the memory store or in the shm store."""
        if self.memstore is not None and self.memstore.contains_value(oid):
            return True
        return self.store.contains(oid)

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        self._direct.flush_all()  # coalesced submits go out before waiting
        pending = list(refs)
        ready: list[ObjectRef] = []
        deadline = None if timeout is None else time.monotonic() + timeout
        blocked = False
        next_pull = time.monotonic()
        remote_ready: set[bytes] = set()  # fetch_local=False: seen in GCS
        try:
            while True:
                if time.monotonic() >= next_pull:
                    if fetch_local:
                        next_pull = time.monotonic() + _PULL_RETRY_S
                        for ref in pending:
                            if not self._has_local(ref.binary()):
                                self.request_pull(ref.binary())
                    else:
                        # ready = sealed ANYWHERE in the cluster (reference
                        # semantics: fetch_local=False doesn't move data)
                        next_pull = time.monotonic() + 0.2
                        for ref in pending:
                            oid = ref.binary()
                            if (oid not in remote_ready
                                    and not self._has_local(oid)):
                                try:
                                    if self.rpc("object_locations",
                                                {"oid": oid}):
                                        remote_ready.add(oid)
                                except Exception:
                                    pass
                still = []
                for ref in pending:
                    if (self._has_local(ref.binary())
                            or ref.binary() in remote_ready):
                        ready.append(ref)
                    else:
                        still.append(ref)
                pending = still
                if len(ready) >= num_returns or not pending:
                    return ready, pending
                if deadline is not None and time.monotonic() >= deadline:
                    return ready, pending
                if not blocked and self._block_notify is not None:
                    self._block_notify(True)
                    blocked = True
                time.sleep(0.005)
        finally:
            if blocked:
                self._block_notify(False)

    # -- function registry (store doubles as the GCS function KV) ----------
    def register_function(self, fn) -> bytes:
        cached = self._fn_cache.get(id(fn))
        if cached is not None and cached[0] is fn and self.store.contains(cached[1]):
            return cached[1]
        blob = cloudpickle.dumps(fn)
        fn_id = ids.random_object_id()
        buf = self.store.create(fn_id, len(blob))
        try:
            buf[:] = blob
        finally:
            buf.release()
        self.store.seal(fn_id)
        if self._seal_notify is not None:
            self._seal_notify(fn_id)
        # Mirror into the GCS KV: fn blobs are plain puts with NO lineage,
        # so a store-daemon crash would otherwise strand every in-flight
        # spec naming this fn_id (workers probe the fn_blob KV before the
        # pull wait — worker_main._load_function).  The store copy stays
        # the fast path; this is the durable fallback.
        try:
            self.rpc("kv_put", {"namespace": "fn_blob", "key": fn_id,
                                "value": blob})
        except Exception:
            pass
        self._fn_cache[id(fn)] = (fn, fn_id)
        return fn_id


_MEMSTORE_FALLTHROUGH = object()
_STORE_MISS = object()  # store fetch miss (a stored value may be None)

_global_worker: Optional[WorkerContext] = None


def set_global_worker(w: Optional[WorkerContext]):
    global _global_worker
    _global_worker = w
    # The ObjectRef hooks always track the CURRENT context: cleared on
    # shutdown (a dead context must not be called from pickling/GC) and
    # re-installed when a context is restored (tests swap contexts while
    # running several clusters in one process).
    from ray_tpu_torch.core import object_ref as object_ref_mod

    if w is not None and getattr(w, "memstore", None) is not None:
        object_ref_mod.set_escape_hook(w._on_ref_escape)
        object_ref_mod.set_lifecycle_hooks(w._on_ref_created,
                                           w._on_ref_deleted)
    else:
        object_ref_mod.set_escape_hook(None)
        object_ref_mod.set_lifecycle_hooks(None, None)


def global_worker() -> WorkerContext:
    if _global_worker is None:
        raise RuntimeError(
            "ray_tpu has not been initialized; call ray_tpu_torch.init() first"
        )
    return _global_worker


def global_worker_or_none() -> Optional[WorkerContext]:
    return _global_worker


def is_initialized() -> bool:
    return _global_worker is not None
