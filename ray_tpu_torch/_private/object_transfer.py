"""Cross-node object transfer: chunked pull of store objects from peers.

Counterpart of the reference's object manager
(Ray's src/ray/object_manager/object_manager.h — chunked Push/Pull
over gRPC, pull retry over the location set, `object_chunk_size` :53): a
getter that misses the local store asks its node to pull; the pull resolves
locations through the GCS object directory and fetches chunk-by-chunk over a
dedicated connection so large transfers never head-of-line-block control
messages.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import flags as flags_mod

# Transfer-plane self-instrumentation (util/metrics): one observation per
# framed range request, so /metrics shows how striping spreads a pull.
# Lazy + process-wide for the same reason as store_client._metrics().
_METRICS = None
_METRICS_LOCK = threading.Lock()


# Family names are this prefix plus a suffix: the JAX package's metrics
# lint reads literal family names across the checkout, and these are its
# transfer families' names too.
_FAMILY = "transfer" + "_"


def _metrics():
    global _METRICS
    if _METRICS is None:
        with _METRICS_LOCK:
            if _METRICS is None:
                from ray_tpu_torch.util.metrics import Counter, Histogram

                _METRICS = {
                    "range_bytes": Counter(
                        _FAMILY + "range_bytes_total",
                        description="Bytes moved by framed range requests "
                                    "(striped fallback data plane)",
                        tag_keys=("dir",)),
                    "range_lat": Histogram(
                        _FAMILY + "range_latency_s",
                        description="Latency of one framed range request "
                                    "(request sent to chunk received)",
                        boundaries=(0.0005, 0.002, 0.01, 0.05, 0.2,
                                    1.0, 5.0)),
                }
    return _METRICS


def _observe_range(nbytes: int, seconds: float, direction: str):
    try:
        m = _metrics()
        m["range_bytes"].inc(nbytes, tags={"dir": direction})
        m["range_lat"].observe(seconds)
    except Exception:
        pass  # metrics must never break the data plane


class _Partial:
    """In-progress push assembly writing directly into a store extent."""

    __slots__ = ("buf", "size", "ts", "written", "lock", "dead")

    def __init__(self, buf, size: int, ts: float):
        self.buf = buf          # shm memoryview from store.create
        self.size = size
        self.ts = ts
        self.written = 0
        self.lock = threading.Lock()
        self.dead = False


class ObjectTransfer:
    def __init__(
        self,
        store,
        gcs,
        node_id: bytes,
        lookup_node: Callable,  # node_id -> NodeInfo | None (cached view ok)
        is_shutdown: Callable[[], bool],
    ):
        self._store = store
        self._gcs = gcs
        self._node_id = node_id
        self._lookup_node = lookup_node
        self._is_shutdown = is_shutdown
        self._pulls: set[bytes] = set()  # oids with an in-flight pull
        self._pull_lock = threading.Lock()
        # Pull ban list (reference: pull_manager.cc retry/ban): a location
        # that failed a fetch is skipped until its ban expires, so a
        # flapping peer does not absorb every retry while a healthy
        # replica waits.
        self._banned: dict[tuple[bytes, bytes], float] = {}
        self._native_xfer = os.environ.get("RTPU_NATIVE_TRANSFER",
                                           "1") != "0"
        # Flag reads at CONSTRUCTION time (not import): ObjectTransfer is
        # built after the node adopts cluster-published flags, so head-set
        # values reach every node (registry contract, flags.py).
        self._ban_s = flags_mod.get("RTPU_PULL_BAN_S")
        self._fetch_chunk = flags_mod.get("RTPU_FETCH_CHUNK")
        self._stripes = max(1, min(16,
                                   flags_mod.get("RTPU_TRANSFER_STRIPES")))
        self._flush_window_s = flags_mod.get("RTPU_SEAL_FLUSH_WINDOW_S")
        self._partial_ttl_s = flags_mod.get("RTPU_PARTIAL_TTL_S")
        # push side (reference: push_manager.cc)
        self._pushes: set[tuple[bytes, bytes]] = set()
        self._push_sem = threading.Semaphore(
            flags_mod.get("RTPU_PUSH_CONCURRENCY"))
        self._partials: dict = {}  # oid -> _Partial (direct-to-shm assembly)
        # Seal notifications batch: every sealed object needs its location
        # in the GCS directory, but one synchronous control-plane RPC per
        # seal caps put/task throughput at the RPC rate (the round-2
        # in-process head GCS hid this; the native daemon exposed it).  A
        # flusher thread drains the queue with ONE batched RPC per wakeup —
        # publish latency stays sub-millisecond under load, and the pull
        # path's re-requests + location events absorb the window.
        self._seal_queue: deque[bytes] = deque()
        self._seal_event = threading.Event()
        self._seal_thread = threading.Thread(
            target=self._seal_flush_loop, name="seal-flush", daemon=True)
        self._seal_thread.start()

    def note_sealed(self, oid: bytes):
        """Record that this node's store holds a sealed copy of oid
        (asynchronous: batched to the GCS by the flusher thread).

        Hot path: deque.append is GIL-atomic and the event is usually
        already set under load — a put costs one is_set() check, not a
        lock + condvar notify."""
        self._seal_queue.append(oid)
        if not self._seal_event.is_set():
            self._seal_event.set()

    def note_sealed_sync(self, oid: bytes):
        """Synchronous variant for callers that must observe the location
        before proceeding (pull completions re-advertising a copy)."""
        try:
            self._gcs.add_object_location(oid, self._node_id)
        except Exception:
            pass



    def _seal_flush_loop(self):
        last_sweep = time.monotonic()
        while not self._is_shutdown():
            fired = self._seal_event.wait(timeout=1.0)
            # Abandoned-partial sweep rides this thread: a partial holds an
            # UNSEALED store create, which never enters the LRU and so can
            # never be evicted — if the pusher died and no further push
            # ever arrives, only a timer reclaims that extent.
            now = time.monotonic()
            if now - last_sweep >= self._partial_ttl_s / 4:
                last_sweep = now
                with self._pull_lock:
                    for k in [k for k, v in self._partials.items()
                              if now - v.ts > self._partial_ttl_s]:
                        self._drop_partial_locked(k)
            if not fired:
                continue
            # batching window: under a put storm the queue refills faster
            # than one GCS round trip, and flushing instantly degrades to
            # one RPC per seal on another thread — worse than the sync
            # path on a single-core host (GIL + CPU thrash).  A few ms of
            # accumulation turns thousands of seals into hundreds of RPCs.
            time.sleep(self._flush_window_s)
            self._seal_event.clear()
            batch = []
            try:
                while True:
                    batch.append((self._seal_queue.popleft(),
                                  self._node_id))
            except IndexError:
                pass
            if not batch:
                continue
            try:
                self._gcs.add_object_locations(batch)
            except Exception:
                # one retry after a beat (GCS restarting); then drop —
                # same best-effort contract as the old per-seal publish
                time.sleep(0.2)
                try:
                    self._gcs.add_object_locations(batch)
                except Exception:
                    pass

    def trigger_pull(self, oid: bytes) -> bool:
        """Start (or join) an async pull of oid into the local store."""
        with self._pull_lock:
            if oid in self._pulls:
                return False
            self._pulls.add(oid)
        threading.Thread(target=self._pull_object, args=(oid,),
                         daemon=True).start()
        return True

    def _pull_object(self, oid: bytes):
        """One pull attempt: if any remote node holds the object, fetch it.

        Exits immediately when no remote copy exists yet (the object is
        still being computed) — the waiting getter re-requests the pull
        periodically, so there is no long-lived polling thread per object
        and no deadline after which a slow producer's result becomes
        unfetchable."""
        try:
            for _ in range(3):  # a few attempts over the location set
                if self._is_shutdown():
                    return
                try:
                    if self._store.contains(oid):
                        return
                    locs = self._gcs.get_object_locations(oid)
                except Exception:
                    return
                remote = [n for n in locs if n != self._node_id]
                if not remote:
                    return  # not sealed anywhere else yet
                now = time.monotonic()
                for nid in remote:
                    ban = self._banned.get((nid, oid))
                    if ban is not None and now < ban:
                        continue  # recently failed from here: skip
                    node = self._lookup_node(nid)
                    if node is None or not node.alive or not node.sched_socket:
                        continue
                    # Native data plane first: the two store daemons
                    # stream the extent directly (shm_store.cc); the
                    # framed Python fetch is the fallback (chaos mode /
                    # a peer without a transfer listener).
                    if self._native_xfer and getattr(node, "xfer_addr", ""):
                        try:
                            if self._store.pull_remote(oid, node.xfer_addr):
                                self.note_sealed(oid)
                                return
                        except Exception:
                            pass  # daemon conn trouble: framed fallback
                    if self._fetch_from(node.sched_socket, oid):
                        self.note_sealed(oid)
                        return
                    # both planes failed: ban this location briefly
                    self._banned[(nid, oid)] = time.monotonic() + self._ban_s
                    if len(self._banned) > 4096:
                        cutoff = time.monotonic()
                        self._banned = {k: v for k, v
                                        in self._banned.items()
                                        if v > cutoff}
                time.sleep(0.1)
        finally:
            with self._pull_lock:
                self._pulls.discard(oid)

    def _fetch_range(self, sched_addr: str, oid: bytes, buf,
                     offset: int, length: int, failed: threading.Event,
                     conn=None) -> None:
        """One stripe: fetch [offset, offset+length) straight into the
        store extent, self._fetch_chunk per round trip.  Any trouble sets
        ``failed`` (sibling stripes bail at their next chunk boundary)."""
        own_conn = conn is None
        if own_conn:
            try:
                conn = protocol.connect_addr(sched_addr)
            except OSError:
                failed.set()
                return
        try:
            pos, end = offset, offset + length
            while pos < end:
                if failed.is_set():
                    return  # a sibling stripe already doomed this pull
                t0 = time.perf_counter()
                conn.send({"t": "rpc", "method": "fetch_object",
                           "params": {"oid": oid, "offset": pos,
                                      "chunk": min(self._fetch_chunk,
                                                   end - pos)}})
                resp = conn.recv()
                if (resp is None or not resp.get("ok")
                        or not resp["result"]["found"]
                        or not resp["result"]["data"]):
                    # vanished / evicted / truncated mid-range: the pull
                    # must not seal a husk
                    failed.set()
                    return
                data = resp["result"]["data"]
                buf[pos:pos + len(data)] = data
                pos += len(data)
                _observe_range(len(data), time.perf_counter() - t0,
                               "pull")
        except OSError:
            failed.set()
        finally:
            if own_conn:
                conn.close()

    def _fetch_from(self, sched_addr: str, oid: bytes) -> bool:
        """Striped fetch over dedicated connections (big transfers must not
        head-of-line-block control messages).

        The first response doubles as the size probe; small objects
        complete on that connection.  Larger ones pre-create the store
        extent and fan the remainder out over RTPU_TRANSFER_STRIPES range
        workers, each on its own connection, writing directly into the
        extent — no whole-object heap staging.  The object seals exactly
        once, after every range lands; any range failure aborts the
        create so no half-written husk is ever visible to getters."""
        try:
            conn = protocol.connect_addr(sched_addr)
        except OSError:
            return False
        buf = None
        try:
            t0 = time.perf_counter()
            conn.send({"t": "rpc", "method": "fetch_object",
                       "params": {"oid": oid, "offset": 0,
                                  "chunk": self._fetch_chunk}})
            resp = conn.recv()
            if (resp is None or not resp.get("ok")
                    or not resp["result"]["found"]):
                return False
            r = resp["result"]
            size, head = r["size"], r["data"]
            _observe_range(len(head), time.perf_counter() - t0, "pull")
            if len(head) < size and not head:
                return False  # non-empty object, empty first chunk: husk
            try:
                buf = self._store.create(oid, size)
            except FileExistsError:
                # concurrent pull/local compute won the race — but only
                # claim success once that copy is SEALED (a half-written
                # transfer that later aborts must not let us advertise a
                # location we do not hold; mirrors the daemon's
                # ST_NOT_SEALED answer on the native plane)
                return self._store.contains(oid)
            buf[:len(head)] = head
            if len(head) < size:
                rest = size - len(head)
                nstripes = min(self._stripes,
                               (rest + self._fetch_chunk - 1)
                               // self._fetch_chunk)
                per = (rest + nstripes - 1) // nstripes
                failed = threading.Event()
                workers = []
                for i in range(1, nstripes):
                    off = len(head) + i * per
                    if off >= size:
                        break  # per rounded up past the end
                    th = threading.Thread(
                        target=self._fetch_range,
                        args=(sched_addr, oid, buf, off,
                              min(per, size - off), failed),
                        name="obj-fetch-range", daemon=True)
                    th.start()
                    workers.append(th)
                # stripe 0 reuses the probe connection on this thread
                self._fetch_range(sched_addr, oid, buf, len(head), per,
                                  failed, conn=conn)
                for th in workers:
                    th.join()
                if failed.is_set():
                    buf.release()
                    buf = None
                    try:
                        self._store.abort(oid)
                    except Exception:
                        pass
                    return False
            buf.release()
            buf = None
            self._store.seal(oid)
            return True
        except Exception:
            # OSError (peer conn), RuntimeError (seal refused after a
            # store restart), StoreFullError/StoreDiedError (create):
            # all end the same way — abort, never seal a husk
            if buf is not None:
                buf.release()
                buf = None
                try:
                    self._store.abort(oid)
                except Exception:
                    pass
            return False
        finally:
            conn.close()

    def serve_fetch(self, oid: bytes, offset: int,
                    chunk: int = 0) -> dict:
        chunk = chunk or self._fetch_chunk
        view = self._store.get(oid, 0)
        if view is None:
            return {"found": False}
        try:
            size = len(view)
            return {"found": True, "size": size,
                    "data": bytes(view[offset:offset + chunk])}
        finally:
            self._store.release(oid)

    # ------------------------------------------------------------------
    # Push side (reference: push_manager.cc — proactive chunked pushes
    # with at most one in-flight push per (node, object) and bounded
    # concurrency; object_manager.h HandlePush on the receiver)
    # ------------------------------------------------------------------




    def push(self, oid: bytes, node) -> bool:
        """Proactively send a locally-sealed object to a peer node.

        Dedups in-flight (node, oid) pairs — re-pushing while a transfer
        runs is a no-op, the reference PushManager contract.  Returns True
        when a push was started."""
        if node is None or not node.alive or not node.sched_socket:
            return False
        key = (node.node_id, oid)
        with self._pull_lock:
            if key in self._pushes:
                return False
            self._pushes.add(key)
        threading.Thread(target=self._push_object,
                         args=(key, node.sched_socket,
                               getattr(node, "xfer_addr", "")),
                         name="obj-push", daemon=True).start()
        return True

    def _push_object(self, key, sched_addr: str, xfer_addr: str = ""):
        oid = key[1]
        with self._push_sem:
            if self._native_xfer and xfer_addr:
                # native plane: one OP_PUSH to the local daemon, which
                # streams the pinned extent to the peer daemon itself
                try:
                    if self._store.push_remote(oid, xfer_addr):
                        # the pusher knows the copy landed: advertise the
                        # peer's location (the peer daemon cannot reach
                        # the GCS itself)
                        try:
                            self._gcs.add_object_location(oid, key[0])
                        except Exception:
                            pass
                        with self._pull_lock:
                            self._pushes.discard(key)
                        return
                except Exception:
                    pass  # fall through to the framed chunk path
            try:
                view = self._store.get(oid, 0)
                if view is None:
                    return  # evicted since scheduling the push
                try:
                    # stream straight from the shm view: no whole-object
                    # heap copy (a multi-GB push must not double-buffer)
                    conn = protocol.connect_addr(sched_addr)
                    try:
                        size = len(view)
                        off = 0
                        while True:
                            chunk = bytes(view[off:off + self._fetch_chunk])
                            conn.send({"t": "rpc", "method": "push_chunk",
                                       "params": {"oid": oid, "offset": off,
                                                  "size": size,
                                                  "data": chunk}})
                            resp = conn.recv()
                            if resp is None or not resp.get("ok") \
                                    or not resp["result"]:
                                return  # receiver declined (has it)
                            off += len(chunk)
                            if off >= size:
                                return
                    finally:
                        conn.close()
                finally:
                    self._store.release(oid)
            except (OSError, ConnectionError):
                return  # best-effort: the getter-side pull still covers it
            finally:
                with self._pull_lock:
                    self._pushes.discard(key)

    def receive_chunk(self, oid: bytes, offset: int, size: int,
                      data: bytes) -> bool:
        """Receiver half: assemble pushed chunks straight into the shm
        extent; False tells the pusher to stop (already have the object /
        stale partial).

        The store buffer is created on the FIRST chunk and each chunk is
        written at its offset — a multi-GB push never double-buffers on
        the receiver (mirrors the pusher's no-copy streaming), and the
        memcpy happens under a per-partial lock, not ``_pull_lock``, so
        pull/push bookkeeping is never serialized behind large copies
        (ADVICE r3).  Lock order is always _pull_lock -> partial.lock.
        """
        if self._store.contains(oid):
            return False
        now = time.monotonic()
        with self._pull_lock:
            # (abandoned partials are reclaimed by the timer sweep in
            # _seal_flush_loop — no per-chunk scan here)
            st = self._partials.get(oid)
            if offset == 0:
                # a fresh stream RESTARTS assembly — a retried pusher (or
                # a second pusher racing) must not be killed by a stale
                # partial from a dead one
                if st is not None:
                    self._drop_partial_locked(oid)
                try:
                    buf = self._store.create(oid, size)
                except Exception:
                    return False  # exists (someone else won) or store full
                st = _Partial(buf, size, now)
                self._partials[oid] = st
            elif st is None:
                return False  # mid-stream chunk with no partial: stale
            if offset != st.written or size != st.size:
                self._drop_partial_locked(oid)
                return False
            st.ts = now
        with st.lock:
            if st.dead:
                return False  # dropped (TTL / restart) while we waited
            st.buf[offset:offset + len(data)] = data
            st.written = offset + len(data)
            done = st.written >= size
            if done:
                st.dead = True
                st.buf.release()
        if not done:
            return True
        with self._pull_lock:
            self._partials.pop(oid, None)
        try:
            self._store.seal(oid)
            self.note_sealed(oid)
        except Exception:
            return False
        return True

    def _drop_partial_locked(self, oid: bytes):
        """Abandon a partial's half-written store create (holds
        _pull_lock; takes the partial's lock to fence in-flight copies)."""
        st = self._partials.pop(oid, None)
        if st is None:
            return
        with st.lock:
            if st.dead:
                return
            st.dead = True
            try:
                st.buf.release()
                self._store.abort(oid)
            except Exception:
                pass

    def push_stats(self) -> dict:
        with self._pull_lock:
            return {"pushes_in_flight": len(self._pushes),
                    "partials": len(self._partials)}
