"""Direct actor-call transport + in-process memory store.

Counterpart of the reference's core-worker fast paths:

- ``CoreWorkerMemoryStore`` (Ray's src/ray/core_worker/
  store_provider/memory_store/): small objects never touch the node's shm
  store daemon — results of direct actor calls land in the CALLER's
  in-process memory store and ``get`` resolves them with a condvar wake,
  not a daemon round-trip.
- Direct task push (``normal_task_submitter.cc:548`` PushNormalTask /
  ``actor_task_submitter.cc``): once an actor is ALIVE, method calls flow
  caller → actor worker over a dedicated connection, bypassing the node
  scheduler entirely.  The scheduler still PLACES actors (the lease); the
  steady-state hot path is two processes and one socket.

Ordering: one connection per (caller, actor) gives per-caller FIFO — the
same guarantee the reference's ActorSchedulingQueue enforces.  The caller
only switches to the direct path once no scheduler-path calls to that actor
are outstanding (see WorkerContext.submit_actor_method), so the transition
window cannot reorder.

Failure model: any transport error (including injected RPC chaos) collapses
to "connection lost".  The caller then re-resolves the actor: still ALIVE
at the same address → reconnect and RESEND outstanding calls (the worker
dedups by task id and replays cached replies, making resend exactly-once);
restarted elsewhere or DEAD → outstanding calls fail with ActorDiedError,
matching the scheduler path's semantics for in-flight methods.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import time
import traceback
from collections import OrderedDict
from typing import Callable, Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import serialization
from ray_tpu_torch.exceptions import ActorDiedError

# Results at or below this serialized size return inline in the reply and
# live in the caller's memory store; larger results go through the shm
# store as before (reference: max_direct_call_object_size, 100KB).
INLINE_MAX = int(os.environ.get("RTPU_INLINE_MAX", 100 * 1024))


# ---------------------------------------------------------------------------
# Wire dialects.  One port serves both:
#
# - legacy frames: pickled dicts (first byte 0x80, the pickle PROTO
#   opcode) — what the pure-Python path speaks.
# - binary frames: hand-packed records (first byte 0x01 call / 0x02 reply /
#   0x03 pickled-spec call) — what the native (_rtpu_core) path speaks; the
#   C++ reply matcher parses 0x02 without the GIL.
#
# The native transport is the default when the extension builds; chaos mode
# forces the Python path so RTPU_TESTING_RPC_FAILURE keeps injecting at the
# frame layer (the C++ threads bypass Python chaos by construction).
# ---------------------------------------------------------------------------

# Frame-kind bytes live in wire_constants (the single Python anchor the
# drift pass compares against core_worker.cc's reply matcher).
from ray_tpu_torch._private.wire_constants import (  # noqa: F401
    FRAME_CALL,
    FRAME_CALL_PICKLED,
    FRAME_REPLY,
)

REPLY_OK = 1  # flags bit0: executed without raising
REPLY_IN_STORE = 2  # flags bit1: result in the shm store, payload empty

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")

_native_core = None
_native_failed = False
_lane_disabled_reported = False


def _report_native_lane_disabled(reason: str):
    """The C++ transport is OFF for this process — say so ONCE, loudly.
    Silently switching lanes under RTPU_TESTING_RPC_FAILURE meant the
    default production path had zero fault-injection coverage and nobody
    could tell from the outside; now every lane switch leaves a warning
    on stderr and a ray_tpu_native_lane_disabled gauge on /metrics."""
    global _lane_disabled_reported
    if _lane_disabled_reported:
        return
    _lane_disabled_reported = True
    import sys

    print(f"[ray_tpu_torch] WARNING: native C++ transport disabled ({reason}); "
          f"tasks and actor calls take the Python fallback lane",
          file=sys.stderr, flush=True)
    try:
        from ray_tpu_torch.util.metrics import Gauge

        # Bare family name: the dashboard renderer prefixes every pushed
        # family with ray_tpu_, so this renders as
        # ray_tpu_native_lane_disabled (see README).
        Gauge("native_lane_disabled",
              description="1 when this process runs with the native C++ "
                          "transport off (chaos injection or "
                          "RTPU_NATIVE_TRANSPORT=0) and dispatch rides "
                          "the Python fallback lane",
              tag_keys=("reason",)).set(1, {"reason": reason})
    except Exception:
        pass  # metrics must never block the lane decision


def native_core():
    """The _rtpu_core extension, or None (unavailable / disabled)."""
    global _native_core, _native_failed
    if _native_core is not None or _native_failed:
        return _native_core
    if os.environ.get("RTPU_NATIVE_TRANSPORT", "1") == "0":
        _native_failed = True
        _report_native_lane_disabled("RTPU_NATIVE_TRANSPORT=0")
        return None
    if os.environ.get("RTPU_TESTING_RPC_FAILURE"):
        # chaos injects at the Python frame layer; the C++ threads would
        # bypass it, so the whole transport drops to the Python lane
        _native_failed = True
        _report_native_lane_disabled("RTPU_TESTING_RPC_FAILURE chaos")
        return None
    try:
        from ray_tpu_torch.native.build import load_extension

        _native_core = load_extension("_rtpu_core")
    except Exception:
        _native_failed = True
        _report_native_lane_disabled("extension failed to load")
    return _native_core


def pack_call_frame(spec) -> bytes:
    """Binary call record; falls back to a pickled-spec record for specs
    the compact form can't carry (multi-return, device tensors, ...)."""
    simple = (len(spec.return_ids) == 1 and spec.tensor_transport is None
              and spec.method_name is not None
              and len(spec.method_name) < 65536
              # the compact frame has no slot for a trace context; traced
              # calls ride the pickled form so propagation survives
              and getattr(spec, "trace_id", None) is None)
    if not simple:
        body = pickle.dumps(spec, protocol=5)
        return (bytes([FRAME_CALL_PICKLED, len(spec.task_id)])
                + spec.task_id + body)
    m = spec.method_name.encode("utf-8")
    parts = [bytes([FRAME_CALL, len(spec.task_id)]), spec.task_id,
             bytes([len(spec.return_ids[0])]), spec.return_ids[0],
             bytes([len(spec.actor_id)]), spec.actor_id,
             _U16.pack(len(m)), m, spec.args_blob or b""]
    return b"".join(parts)


def parse_direct_frame(frame: bytes):
    """-> ("call", spec) | ("hello", None) | (None, None) for any dialect."""
    if not frame:
        return None, None
    kind = frame[0]
    if kind == 0x80:  # legacy pickled dict
        msg = pickle.loads(frame)
        t = msg.get("t")
        if t == "call":
            return "call", msg["spec"]
        return ("hello", None) if t == "hello" else (None, None)
    if kind == FRAME_CALL_PICKLED:
        tl = frame[1]
        return "call", pickle.loads(frame[2 + tl:])
    if kind == FRAME_CALL:
        pos = 1
        tl = frame[pos]; pos += 1
        tid = frame[pos:pos + tl]; pos += tl
        rl = frame[pos]; pos += 1
        rid = frame[pos:pos + rl]; pos += rl
        al = frame[pos]; pos += 1
        aid = frame[pos:pos + al]; pos += al
        (ml,) = _U16.unpack_from(frame, pos); pos += 2
        method = frame[pos:pos + ml].decode("utf-8"); pos += ml
        return "call", _fast_method_spec(tid, rid, aid, method, frame[pos:])
    return None, None


def _fast_method_spec(tid, rid, aid, method, args_blob):
    """Hot-path TaskSpec: skip the 20-field dataclass __init__ — start
    from a frozen defaults dict and overwrite the 7 live fields."""
    from ray_tpu_torch._private.task_spec import TaskSpec

    spec = TaskSpec.__new__(TaskSpec)
    defaults, mutable_keys = _method_spec_defaults()
    spec.__dict__.update(defaults)
    for key in mutable_keys:
        # never share the template's mutable defaults across specs — a
        # handler mutating one in place would corrupt concurrent tasks
        spec.__dict__[key] = type(defaults[key])()
    spec.task_id = tid
    spec.args_blob = args_blob
    spec.return_ids = [rid]
    spec.actor_id = aid
    spec.method_name = method
    spec.name = method
    return spec


_METHOD_SPEC_DEFAULTS = None


def _method_spec_defaults() -> tuple:
    """(defaults dict, keys holding mutable values) — the mutable set is
    DISCOVERED from the template, so a future TaskSpec field with a
    list/dict/set default is copied per spec automatically."""
    global _METHOD_SPEC_DEFAULTS
    if _METHOD_SPEC_DEFAULTS is None:
        from ray_tpu_torch._private.task_spec import ACTOR_METHOD, TaskSpec

        template = TaskSpec(task_id=b"", kind=ACTOR_METHOD, fn_id=b"",
                            args_blob=b"", return_ids=[])
        defaults = dict(template.__dict__)
        mutable = tuple(k for k, v in defaults.items()
                        if isinstance(v, (list, dict, set)))
        _METHOD_SPEC_DEFAULTS = (defaults, mutable)
    return _METHOD_SPEC_DEFAULTS


def encode_direct_reply(request_first_byte: int, reply: dict) -> bytes:
    """Encode a reply dict in the dialect of the request it answers."""
    if request_first_byte in (FRAME_CALL, FRAME_CALL_PICKLED):
        flags = (REPLY_OK if reply.get("ok") else 0) | (
            REPLY_IN_STORE if reply.get("in_store") else 0)
        tid = reply["task_id"]
        return (bytes([FRAME_REPLY, len(tid)]) + tid + bytes([flags])
                + (reply.get("payload") or b""))
    return pickle.dumps(reply, protocol=5)

_MEMSTORE_MAX_ENTRIES = int(os.environ.get("RTPU_MEMSTORE_ENTRIES", 65536))
_MEMSTORE_MAX_BYTES = int(os.environ.get("RTPU_MEMSTORE_BYTES", 256 << 20))
# exactly-once resend dedup: completed inline payloads pinned per actor
_DONE_BYTES_CAP = int(
    os.environ.get("RTPU_DIRECT_DONE_BYTES_CAP", 32 << 20))


class _Entry:
    __slots__ = ("done", "event", "payload", "in_store", "promoted",
                 "escaped", "orphaned")

    def __init__(self):
        # ``done`` is the fulfillment flag; the Event is created LAZILY by
        # the first waiter (memstore.wait_done).  Most direct-call replies
        # land before anyone blocks, so the common path never pays for an
        # Event+Condition+lock allocation.
        self.done = False
        self.event: Optional[threading.Event] = None
        self.payload: Optional[bytes] = None  # store-format payload
        self.in_store = False  # result went to the shm store instead
        self.promoted = False  # payload was copied to the shm store too
        # the ref was pickled while the call was still in flight: the value
        # must be promoted to the shm store the moment it arrives, because
        # another process may already be blocking on it there
        self.escaped = False
        # every LOCAL ref died while the call was in flight; drop the
        # entry once its delivery obligations (promotion) are met
        self.orphaned = False


class MemoryStore:
    """In-process object store for small objects (store-format payloads).

    States per oid: pending (direct call in flight), fulfilled (payload
    bytes present), or in-store (value lives in the shm store — callers
    fall through to the daemon path).  Bounded: oldest fulfilled entries
    are promoted to the shm store and dropped when over the cap.
    """

    def __init__(self, promote_cb: Optional[Callable[[bytes, bytes], None]] = None):
        # RLock: ObjectRef.__del__ (GC, can fire on ANY thread at ANY
        # point, including while this very thread holds the lock) calls
        # discard() — a plain Lock would self-deadlock.
        self._lock = threading.RLock()
        self._entries: OrderedDict[bytes, _Entry] = OrderedDict()
        self._bytes = 0
        self._promote_cb = promote_cb

    def expect(self, oid: bytes) -> None:
        """Pre-register a pending entry (a direct call will fulfill it)."""
        with self._lock:
            if oid not in self._entries:
                self._entries[oid] = _Entry()

    def put_payload(self, oid: bytes, payload: bytes) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                # no expect()ed entry: the last local ref was dropped
                # (fire-and-forget call) — nobody can ever read this
                return
            if e.done:
                return  # first fulfillment wins (retried call)
            e.payload = payload
            self._bytes += len(payload)
            escaped = e.escaped and not e.promoted
            if escaped:
                e.promoted = True
            e.done = True
            if e.event is not None:
                e.event.set()
            if e.orphaned:
                # all local refs died mid-flight; the entry only survived
                # for its promotion duty — drop it now
                self._entries.pop(oid, None)
                self._bytes -= len(payload)
            evict = self._over_cap_locked()
        if escaped and self._promote_cb is not None:
            # the ref left this process while the call was in flight;
            # someone may be blocking on the shm store for it right now
            try:
                self._promote_cb(oid, payload)
            except Exception:
                pass
        for oid_e, payload_e in evict:
            if self._promote_cb is not None:
                try:
                    self._promote_cb(oid_e, payload_e)
                except Exception:
                    pass

    def mark_escaped(self, oid: bytes) -> Optional[bytes]:
        """The ref is being pickled (may leave the process).  Returns a
        payload the CALLER must promote to the shm store now (fulfilled,
        unpromoted entries); pending entries are flagged and promote
        themselves on delivery."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None or e.in_store or e.promoted:
                return None
            if not e.done:
                e.escaped = True
                return None
            e.promoted = True
            return e.payload

    def mark_in_store(self, oid: bytes) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return  # last local ref dropped; store copy stands alone
            if not e.done:
                e.in_store = True
                e.done = True
                if e.event is not None:
                    e.event.set()
            if e.orphaned:
                self._entries.pop(oid, None)

    def _over_cap_locked(self) -> list[tuple[bytes, bytes]]:
        """Collect fulfilled entries to evict (promote) — caller promotes
        outside the lock."""
        evict: list[tuple[bytes, bytes]] = []
        while (len(self._entries) > _MEMSTORE_MAX_ENTRIES
               or self._bytes > _MEMSTORE_MAX_BYTES):
            victim = None
            for oid, e in self._entries.items():
                if e.done:
                    victim = (oid, e)
                    break
            if victim is None:
                break  # only pending entries left: nothing evictable
            oid, e = victim
            del self._entries[oid]
            if e.payload is not None:
                self._bytes -= len(e.payload)
                evict.append((oid, e.payload))
        return evict

    def wait_done(self, e: _Entry, timeout: Optional[float]) -> bool:
        """Block until the entry fulfills; creates its Event on demand."""
        if e.done:
            return True
        with self._lock:
            if e.done:
                return True
            if e.event is None:
                e.event = threading.Event()
            ev = e.event
        return ev.wait(timeout)

    def lookup(self, oid: bytes) -> Optional[_Entry]:
        with self._lock:
            e = self._entries.get(oid)
            if e is not None:
                self._entries.move_to_end(oid)  # LRU touch
            return e

    def contains_value(self, oid: bytes) -> bool:
        """True if a payload is present RIGHT NOW (for wait())."""
        e = self.lookup(oid)
        return e is not None and e.done and not e.in_store

    def discard(self, oid: bytes) -> None:
        """Last local ref died.  A pending ESCAPED entry is kept (marked
        orphaned): a remote process may be blocking on the shm store for
        this value, and only the delivery path can promote it there."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return
            if not e.done and e.escaped:
                e.orphaned = True
                return
            self._entries.pop(oid, None)
            if e.payload is not None:
                self._bytes -= len(e.payload)


def fail_payload(exc: BaseException, tb: str = "") -> bytes:
    """Store-format error payload (get() on it raises, like the store)."""
    return serialization.serialize_error(exc, tb)


# ---------------------------------------------------------------------------
# Caller side
# ---------------------------------------------------------------------------

class _ChannelBase:
    """Shared half of a caller→actor channel: outstanding bookkeeping and
    the in-place repair state machine.

    Per-caller FIFO holds across transport failures: the channel repairs
    itself IN PLACE under its lock — outstanding calls are resent over the
    fresh transport before any new ``call`` (blocked on the lock) can
    send, so resends can never be overtaken.  Repair gives up (and fails
    the outstanding calls with ActorDiedError) when the actor is no longer
    ALIVE at this address.  Subclasses provide the transport: ``call`` and
    ``_reconnect_resend`` (reconnect + resend every outstanding spec +
    start the reply reader; raises/returns None on failure).
    """

    def __init__(self, actor_id: bytes, addr: str, client: "DirectClient"):
        self.actor_id = actor_id
        self.addr = addr
        self._client = client
        self._lock = threading.Lock()
        # task_id -> spec, in send order (for resend after reconnect)
        self._outstanding: OrderedDict[bytes, object] = OrderedDict()
        self.dead = False
        self._epoch = 0  # bumps per successful repair; stale readers exit

    def _deliver(self, task_id: bytes, in_store: bool, payload):
        with self._lock:
            spec = self._outstanding.pop(task_id, None)
        if spec is None:
            return
        if in_store:
            for oid in spec.return_ids:
                self._client.memstore.mark_in_store(oid)
        else:
            self._client.memstore.put_payload(spec.return_ids[0], payload)

    def _reconnect_resend(self) -> bool:
        raise NotImplementedError

    def flush(self) -> None:
        """Push any coalesced frames to the wire (no-op transports that
        send eagerly override nothing)."""

    def _on_broken(self, epoch: int):
        """Transport lost (EOF, reset, or injected chaos): repair in
        place; if the actor is gone, fail the outstanding calls and
        retire the channel."""
        with self._lock:
            if self.dead or epoch != self._epoch:
                return  # a newer incarnation already took over
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                state, addr = self._client.resolve(self.actor_id,
                                                   use_cache=False)
                if state is None:
                    # resolve itself failed (transient control-plane error,
                    # e.g. injected chaos): retry within the deadline
                    time.sleep(0.1)
                    continue
                if state != "ALIVE" or addr != self.addr:
                    break  # dead/restarting/moved: in-flight calls are lost
                try:
                    ok = self._reconnect_resend()
                except (OSError, ConnectionError):
                    ok = False
                if not ok:
                    # partial resends are absorbed by the callee's dedup
                    time.sleep(0.1)
                    continue
                self._epoch += 1
                return
            # actor unreachable: retire the channel, fail what's in flight
            self.dead = True
            pending = list(self._outstanding.values())
            self._outstanding.clear()
        self._client._forget(self.actor_id, self)
        err = fail_payload(ActorDiedError(
            "actor died while executing method (direct call lost)"))
        for spec in pending:
            for oid in spec.return_ids:
                self._client.memstore.put_payload(oid, err)


class _Channel(_ChannelBase):
    """Pure-Python transport: pickled frames, reader thread per channel."""

    def __init__(self, actor_id: bytes, addr: str, client: "DirectClient"):
        super().__init__(actor_id, addr, client)
        self._conn = protocol.connect_addr(addr, timeout=5.0)
        self._start_reader(self._conn, self._epoch)

    def _start_reader(self, conn, epoch: int):
        threading.Thread(target=self._read_loop, args=(conn, epoch),
                         name="direct-read", daemon=True).start()

    def call(self, spec) -> bool:
        with self._lock:
            if self.dead:
                return False
            self._outstanding[spec.task_id] = spec
            for oid in spec.return_ids:
                self._client.memstore.expect(oid)
            try:
                self._conn.send({"t": "call", "spec": spec})
            except (OSError, ConnectionError):
                # the repair path owns it now (runs under this same lock
                # from the reader thread once it sees the broken conn)
                pass
            return True

    def _read_loop(self, conn, epoch: int):
        while True:
            try:
                msg = conn.recv()
            except (OSError, ConnectionError):
                msg = None
            if msg is None:
                try:
                    conn.close()
                except OSError:
                    pass
                self._on_broken(epoch)
                return
            if msg.get("t") != "result":
                continue
            self._deliver(msg["task_id"], bool(msg.get("in_store")),
                          msg.get("payload"))

    def _reconnect_resend(self) -> bool:
        fresh = protocol.connect_addr(self.addr, timeout=5.0)
        for spec in self._outstanding.values():
            fresh.send({"t": "call", "spec": spec})
        self._conn = fresh
        self._start_reader(fresh, self._epoch + 1)
        return True


class _NativeChannel(_ChannelBase):
    """_rtpu_core transport: C++ owns framing, socket I/O, and reply
    parsing; one Python drain thread delivers ready results into the
    memstore.  Repair semantics are _ChannelBase's, with frames re-packed
    from the outstanding specs on the (rare) resend path."""

    def __init__(self, actor_id: bytes, addr: str, client: "DirectClient"):
        super().__init__(actor_id, addr, client)
        self._ch = self._connect()
        self._start_drain(self._ch, self._epoch)

    def _connect(self):
        # protocol.connect_addr performs the TCP cluster-token handshake
        # in Python; the raw fd (post-handshake) is handed to C++
        conn = protocol.connect_addr(self.addr, timeout=5.0)
        return native_core().Channel(conn.sock.detach())

    def _start_drain(self, ch, epoch: int):
        threading.Thread(target=self._drain_loop, args=(ch, epoch),
                         name="direct-drain", daemon=True).start()

    def call(self, spec) -> bool:
        buffered = False
        with self._lock:
            if self.dead:
                return False
            self._outstanding[spec.task_id] = spec
            for oid in spec.return_ids:
                self._client.memstore.expect(oid)
            try:
                if len(self._outstanding) == 1:
                    # Nothing else in flight: a sync caller is about to
                    # block on this very result — send now (drains any
                    # buffered frames first, so order holds).
                    self._ch.submit(pack_call_frame(spec))
                else:
                    # Fan-out burst: coalesce with no syscall.  The frames
                    # go out on the next flush — the caller's own get/wait
                    # (worker.py flushes before blocking), the client's
                    # safety flusher (~1ms), or the 256KB channel cap.
                    self._ch.submit_buffered(pack_call_frame(spec))
                    buffered = True
            except Exception:
                pass  # drain thread observes the dead channel and repairs
        if buffered:
            self._client._mark_dirty(self)
        return True

    def flush(self) -> None:
        try:
            self._ch.flush()
        except Exception:
            pass  # broken transport: the drain thread repairs

    def _drain_loop(self, ch, epoch: int):
        deliver = self._deliver
        while True:
            try:
                items = ch.recv_replies(30000)
            except ConnectionError:
                self._on_broken(epoch)
                return
            if items is None:
                continue  # idle wakeup
            for item in items:
                if item is None:
                    continue  # malformed reply frame: skip
                tid, flags, payload = item
                deliver(tid, bool(flags & REPLY_IN_STORE), payload)

    def _reconnect_resend(self) -> bool:
        fresh = self._connect()
        if not all(fresh.submit(pack_call_frame(spec))
                   for spec in self._outstanding.values()):
            return False  # dedup absorbs any partial resend
        self._ch = fresh
        self._start_drain(fresh, self._epoch + 1)
        return True


class DirectClient:
    """Per-process registry of direct channels + actor address cache.
    Caller identity IS the connection — per-caller FIFO comes from each
    caller owning its own channel to the actor."""

    def __init__(self, memstore: MemoryStore, rpc: Callable):
        self.memstore = memstore
        self._rpc = rpc  # scheduler rpc(method, params)
        self._channels: dict[bytes, _Channel] = {}
        self._addr_cache: dict[bytes, tuple[float, str, Optional[str]]] = {}
        self._lock = threading.Lock()
        # Channels holding coalesced (unsent) frames.  flush_all() runs
        # before any blocking wait; the safety flusher bounds the latency
        # of fire-and-forget calls that are never followed by a get.
        self._dirty: set = set()
        self._dirty_evt = threading.Event()
        self._flusher_started = False

    def _mark_dirty(self, chan) -> None:
        dirty = self._dirty
        if chan in dirty:
            return  # burst on one channel: first mark armed the flusher
        dirty.add(chan)
        if not self._flusher_started:
            with self._lock:
                if not self._flusher_started:
                    self._flusher_started = True
                    threading.Thread(target=self._flush_loop,
                                     name="direct-flush", daemon=True
                                     ).start()
        self._dirty_evt.set()

    def flush_all(self) -> None:
        while self._dirty:
            try:
                chan = self._dirty.pop()
            except KeyError:
                break
            chan.flush()

    def _flush_loop(self) -> None:
        while True:
            self._dirty_evt.wait()
            self._dirty_evt.clear()
            # let the submitting burst finish; its own get usually flushes
            # first and this pass finds nothing
            time.sleep(0.001)
            self.flush_all()

    def resolve(self, actor_id: bytes,
                use_cache: bool = True) -> tuple[Optional[str], Optional[str]]:
        """(state, addr) for an actor, with a short TTL cache."""
        now = time.monotonic()
        if use_cache:
            hit = self._addr_cache.get(actor_id)
            if hit is not None and now - hit[0] < 1.0:
                return hit[1], hit[2]
        try:
            info = self._rpc("actor_addr", {"actor_id": actor_id})
        except Exception:
            return None, None
        if info is None:
            self._addr_cache[actor_id] = (now, None, None)
            return None, None
        self._addr_cache[actor_id] = (now, info["state"], info.get("addr"))
        return info["state"], info.get("addr")

    def submit(self, spec) -> bool:
        """Try to push an actor method directly; False -> use the
        scheduler path."""
        # A live channel short-circuits resolution: while calls are in
        # flight a transient resolve failure must not bounce this caller
        # back to the scheduler path (that could reorder its stream).
        with self._lock:
            chan = self._channels.get(spec.actor_id)
        if chan is not None and not chan.dead and chan.call(spec):
            return True
        state, addr = self.resolve(spec.actor_id)
        if state != "ALIVE" or not addr:
            return False
        try:
            chan = self._channel_for(spec.actor_id, addr)
        except (OSError, ConnectionError):
            self._addr_cache.pop(spec.actor_id, None)
            return False
        return chan.call(spec)

    def _channel_for(self, actor_id: bytes, addr: str) -> _Channel:
        with self._lock:
            chan = self._channels.get(actor_id)
            if chan is not None and not chan.dead and chan.addr == addr:
                return chan
            cls = _NativeChannel if native_core() is not None else _Channel
            chan = cls(actor_id, addr, self)
            self._channels[actor_id] = chan
            return chan

    def _forget(self, actor_id: bytes, chan: "_Channel"):
        with self._lock:
            if self._channels.get(actor_id) is chan:
                del self._channels[actor_id]
        self._addr_cache.pop(actor_id, None)


# ---------------------------------------------------------------------------
# Worker (callee) side
# ---------------------------------------------------------------------------

class DirectServer:
    """Per-worker listener executing direct actor calls.

    Replies inline for small single-return results; stores large/multi
    results in the shm store and replies in_store.  Dedups by task id so a
    caller reconnect-and-resend (chaos / transient transport loss) replays
    the cached reply instead of re-executing — effective exactly-once.
    """

    def __init__(self, runtime, bind_addr: str):
        self._runtime = runtime  # WorkerRuntime (worker_main)
        self._listener, self.addr = protocol.listener_addr(bind_addr)
        self._is_tcp = protocol.is_tcp_addr(self.addr)
        # task_id -> reply dict (completed) | threading.Event (running)
        self._done: OrderedDict[bytes, dict] = OrderedDict()
        self._done_bytes = 0
        self._done_bytes_cap = _DONE_BYTES_CAP
        self._running: dict[bytes, threading.Event] = {}
        self._state_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._accept_loop, name="direct-accept", daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = protocol.Connection(sock)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: protocol.Connection):
        # TCP callers must pass the cluster-token handshake before any
        # frame of theirs is unpickled (see protocol.py).
        if not protocol.authenticate_server_side(conn, self._is_tcp):
            return
        while True:
            try:
                frame = conn.recv_frame()
            except (OSError, ConnectionError, ValueError):
                conn.close()
                return
            if frame is None:
                conn.close()
                return
            try:
                kind, spec = parse_direct_frame(frame)
            except Exception:
                continue  # malformed frame: drop it, keep the stream
            if kind != "call":
                continue
            first = frame[0]

            def send_reply(reply: dict, _conn=conn, _first=first):
                try:
                    _conn.send_frame(encode_direct_reply(_first, reply))
                except (OSError, ConnectionError):
                    # Reply lost (incl. injected chaos): promote to
                    # connection loss so the caller's resend path takes
                    # over; the cached reply serves the resend.
                    _conn.close()

            self._handle_call(spec, send_reply)

    def _handle_call(self, spec, send_reply: Callable[[dict], None]):
        with self._state_lock:
            cached = self._done.get(spec.task_id)
            if cached is not None:
                running = None
            else:
                running = self._running.get(spec.task_id)
                if running is None:
                    self._running[spec.task_id] = threading.Event()
        if cached is not None:
            send_reply(cached)
            return
        if running is not None:
            self._await_duplicate(spec, running, send_reply)
            return
        rt = self._runtime
        pool = rt.actor_pools.get(spec.actor_id)
        if pool is not None:
            # Concurrent actor (max_concurrency > 1): execute on the pool
            # and reply from the completion callback, so one slow call
            # doesn't serialize this caller's other in-flight calls.
            fut = pool.submit(rt.run_actor_method, spec)
            fut.add_done_callback(
                lambda f: self._complete(spec, self._reply_from(spec, f),
                                         send_reply))
            return
        with rt.actor_lock(spec.actor_id):
            try:
                result = rt.run_actor_method(spec)
                reply = self._pack_result(spec, result)
            except BaseException as e:  # noqa: BLE001 — ship to caller
                reply = self._pack_error(spec, e, traceback.format_exc())
        self._complete(spec, reply, send_reply)

    def _await_duplicate(self, spec, running: threading.Event,
                         send_reply: Callable[[dict], None]):
        """Duplicate of an in-flight call (resend after reconnect): wait
        for the original execution — however long it takes (the scheduler
        path imposes no method deadline either) — then replay its reply.
        Runs on the per-connection thread here; the native server
        overrides to avoid blocking its single executor."""
        while not running.wait(timeout=60):
            pass
        with self._state_lock:
            cached = self._done.get(spec.task_id)
        send_reply(cached or {
            "t": "result", "task_id": spec.task_id, "ok": False,
            "in_store": False,
            "payload": fail_payload(RuntimeError(
                "duplicate direct call completed without a reply"))})

    def _reply_from(self, spec, fut) -> dict:
        exc = fut.exception()
        if exc is not None:
            return self._pack_error(spec, exc, "")
        try:
            return self._pack_result(spec, fut.result())
        except BaseException as e:  # noqa: BLE001
            return self._pack_error(spec, e, traceback.format_exc())

    def _complete(self, spec, reply: dict,
                  send_reply: Callable[[dict], None]):
        with self._state_lock:
            self._done[spec.task_id] = reply
            self._done_bytes += len(reply.get("payload") or b"")
            # Bounded by count AND bytes: the cache only needs to cover the
            # caller's reconnect window (sub-second), so eviction far
            # beyond that is safe — a resend older than the window would
            # re-execute, which is why the dedup guarantee is "effective"
            # exactly-once, not absolute.
            while (len(self._done) > 4096
                   or self._done_bytes > self._done_bytes_cap):
                _, old = self._done.popitem(last=False)
                self._done_bytes -= len(old.get("payload") or b"")
            ev = self._running.pop(spec.task_id, None)
        if ev is not None:
            ev.set()
        send_reply(reply)

    def _pack_error(self, spec, exc: BaseException, tb: str) -> dict:
        rt = self._runtime
        reply = {"t": "result", "task_id": spec.task_id, "ok": False,
                 "in_store": False, "payload": None}
        payload = serialization.serialize_error(exc, tb, raised_by_task=True)
        if len(payload) <= INLINE_MAX and len(spec.return_ids) == 1:
            reply["payload"] = payload
        else:
            for oid in spec.return_ids:
                if serialization.store_error_best_effort(
                        rt.store, oid, exc, tb, raised_by_task=True):
                    rt.notify_sealed(oid)
            reply["in_store"] = True
        return reply

    def _pack_result(self, spec, result) -> dict:
        rt = self._runtime
        reply = {"t": "result", "task_id": spec.task_id, "ok": True,
                 "in_store": False, "payload": None}
        n = len(spec.return_ids)
        if n == 1 and spec.tensor_transport is None:
            size, token = serialization.serialized_size(result)
            if size <= INLINE_MAX:
                buf = bytearray(size)
                serialization.write_payload(memoryview(buf), token)
                reply["payload"] = bytes(buf)
                return reply
        rt.store_returns(spec, result)
        reply["in_store"] = True
        return reply


class NativeDirectServer(DirectServer):
    """DirectServer over the _rtpu_core transport.

    C++ owns accept/framing/reply I/O (reference: the C++ TaskReceiver,
    src/ray/core_worker/transport/task_receiver.cc); ONE Python executor
    thread drains Server.next() and runs user methods — no thread per
    connection, no pickled envelopes on the binary dialect, and the
    executor blocks in C++ with the GIL released.  Dedup/result-packing
    logic is inherited unchanged.
    """

    def __init__(self, runtime, bind_addr: str):
        core = native_core()
        self._runtime = runtime
        listener, self.addr = protocol.listener_addr(bind_addr)
        self._is_tcp = protocol.is_tcp_addr(self.addr)
        token = protocol.cluster_token() if self._is_tcp else ""
        self._srv = core.Server(listener.detach(), int(self._is_tcp),
                                token.encode("utf-8"))
        self._done: OrderedDict[bytes, dict] = OrderedDict()
        self._done_bytes = 0
        self._done_bytes_cap = _DONE_BYTES_CAP
        self._running: dict[bytes, threading.Event] = {}
        self._state_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._exec_loop, name="direct-exec", daemon=True)
        self._thread.start()

    def _exec_loop(self):
        while True:
            try:
                item = self._srv.next(-1)
            except ConnectionError:
                return  # server closed
            if item is None:
                continue
            conn_id, frame = item
            try:
                kind, spec = parse_direct_frame(frame)
            except Exception:
                continue  # malformed frame from an authed peer: drop
            if kind != "call":
                continue
            first = frame[0]

            def send_reply(reply: dict, _cid=conn_id, _first=first):
                # enqueued; the exec thread's next() flushes it (a gone
                # caller resends after reconnecting — dedup replays this)
                self._srv.reply(_cid, encode_direct_reply(_first, reply))

            self._handle_call(spec, send_reply)

    def _await_duplicate(self, spec, running, send_reply):
        # A duplicate's wait must not freeze the single executor thread —
        # every other caller's frames would stall behind one slow method.
        threading.Thread(
            target=DirectServer._await_duplicate,
            args=(self, spec, running, send_reply),
            name="direct-dup-wait", daemon=True).start()


def make_direct_server(runtime, bind_addr: str) -> DirectServer:
    """Native transport when the extension is available, Python otherwise
    (chaos mode forces Python so frame-level injection stays live)."""
    if native_core() is not None:
        return NativeDirectServer(runtime, bind_addr)
    return DirectServer(runtime, bind_addr)
