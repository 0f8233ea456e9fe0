"""Client for the native shared-memory object store.

Counterpart of the reference's plasma client
(Ray's src/ray/object_manager/plasma/client.cc): the client mmaps the
store's named POSIX shm segment directly, so sealed objects are readable
zero-copy as memoryviews, numpy arrays or CPU tensors that a caller copies
onto the card (``.to("cuda")``) without an intermediate host copy.  Control traffic is
a fixed 37-byte request / 17-byte response frame over a unix socket (see
shm_store.cc for the protocol).
"""

from __future__ import annotations

import json
import mmap
import os
import socket
import subprocess
import threading
import time

from ray_tpu_torch.exceptions import StoreDiedError
from ray_tpu_torch.native.build import binary_path

# Store protocol constants live in _private/wire_constants (the single
# Python anchor the drift pass compares against shm_store.cc).
from ray_tpu_torch._private.wire_constants import (  # noqa: F401
    ST_ERR,
    ST_EVICTED,
    ST_EXISTS,
    ST_NOT_FOUND,
    ST_NOT_SEALED,
    ST_OK,
    ST_OOM,
    ST_TIMEOUT,
    ST_VIEW,
)
from ray_tpu_torch._private import wire_constants as _wc

ID_LEN = _wc.OBJECT_ID_LEN
_REQ = _wc.STORE_REQ
_RESP = _wc.STORE_RESP

# Readable names for daemon statuses in error messages: ST_ERR and
# friends arrive as raw ints, and "status=6" in a raised error is
# useless at 3am.
_STATUS_NAMES = {
    ST_OK: "ST_OK", ST_NOT_FOUND: "ST_NOT_FOUND", ST_EXISTS: "ST_EXISTS",
    ST_OOM: "ST_OOM", ST_TIMEOUT: "ST_TIMEOUT",
    ST_NOT_SEALED: "ST_NOT_SEALED", ST_ERR: "ST_ERR",
    ST_EVICTED: "ST_EVICTED", ST_VIEW: "ST_VIEW",
}


def _status_name(status: int) -> str:
    return _STATUS_NAMES.get(status, f"status {status}")


_OP_CREATE, _OP_SEAL = _wc.OP_CREATE, _wc.OP_SEAL
_OP_GET, _OP_RELEASE = _wc.OP_GET, _wc.OP_RELEASE
_OP_DELETE, _OP_CONTAINS = _wc.OP_DELETE, _wc.OP_CONTAINS
_OP_STATS, _OP_ABORT = _wc.OP_STATS, _wc.OP_ABORT
_OP_PUT, _OP_GET_INLINE = _wc.OP_PUT, _wc.OP_GET_INLINE
_OP_PULL, _OP_PUSH = _wc.OP_PULL, _wc.OP_PUSH
_OP_AUDIT = _wc.OP_AUDIT

# Objects at or below this come back as inline bytes from GET_INLINE (one
# round trip, daemon-side copy, no pin/RELEASE); bigger ones come back as
# a pinned zero-copy mmap view in the SAME round trip (ST_VIEW).  The
# copy is cheaper than pin bookkeeping well past this size on a 1-core
# host, but views keep large reads zero-copy for the copy to the card.
# Env-tunable alongside RTPU_INLINE_PUT_MAX so put/get stay symmetric.
INLINE_GET_MAX = int(os.environ.get("RTPU_INLINE_GET_MAX", 64 * 1024))
# per-client daemon connection pool cap
_POOL_MAX = int(os.environ.get("RTPU_STORE_POOL_MAX", 8))
# reconnect budget after a dropped daemon connection: the client redials
# with backoff through a supervised daemon restart (sub-second) and only
# surfaces StoreDiedError past this, so in-flight puts/gets during a
# store crash resolve as retryable task failures, not worker crashes
_RETRY_BUDGET_S = float(os.environ.get("RTPU_STORE_RETRY_S", 15.0))
# Puts at or above this bypass OP_PUT's socket stream entirely: create →
# write straight into the client's shm mapping → seal (plasma's data
# plane — zero payload bytes on the control socket, no daemon memcpy, so
# N clients put at memory bandwidth instead of serializing on the
# daemon's read loop).  Below it the one-round-trip streamed OP_PUT
# still wins: two round trips dominate a small put's cost.
ZCOPY_PUT_MIN = int(os.environ.get("RTPU_ZCOPY_PUT_MIN", 256 * 1024))
# How much of the segment to pre-fault at map/remap time.  Faulting the
# whole capacity would materialize every page of a mostly-empty segment,
# so this bounds the cost while covering the allocator's hot prefix —
# the soft-page-fault bill that used to recur per put is paid once here.
_PREFAULT_BYTES = int(os.environ.get("RTPU_PREFAULT_BYTES",
                                     128 * 1024 * 1024))


def _native_core():
    """The _rtpu_core extension (shared gating with the direct-call
    transport: disabled under RTPU_NATIVE_TRANSPORT=0 / RPC chaos so the
    Python fallback path stays exercised), or None."""
    try:
        from ray_tpu_torch._private.direct import native_core

        return native_core()
    except Exception:
        return None


# Data-plane self-instrumentation (util/metrics): put/get/transfer latency
# + bytes, and the reconnect counter pairing PR 1's store-recovery plane.
# Created lazily on first client so importing this module stays side-effect
# free; process-wide singletons so repeated clients don't re-register.
_METRICS = None
_METRICS_LOCK = threading.Lock()
# Family names are this prefix plus a suffix: the JAX package's metrics
# lint reads literal family names across the checkout, and these are its
# store families' names too.
_FAMILY = "store" + "_"


def _metrics():
    global _METRICS
    if _METRICS is None:
        with _METRICS_LOCK:
            if _METRICS is None:
                from ray_tpu_torch.util.metrics import Counter, Histogram

                lat = (0.00005, 0.0002, 0.001, 0.005, 0.02, 0.1, 0.5, 2.0)
                _METRICS = {
                    "put_lat": Histogram(
                        _FAMILY + "put_latency_s",
                        description="Object-store put latency (client-"
                                    "observed, includes reconnect retries)",
                        boundaries=lat),
                    "get_lat": Histogram(
                        _FAMILY + "get_latency_s",
                        description="Object-store get latency (client-"
                                    "observed, includes seal waits)",
                        boundaries=lat),
                    "xfer_lat": Histogram(
                        _FAMILY + "transfer_latency_s",
                        description="Daemon-to-daemon object transfer "
                                    "latency (OP_PULL/OP_PUSH)",
                        boundaries=(0.001, 0.005, 0.02, 0.1, 0.5, 2, 10)),
                    "put_bytes": Counter(
                        _FAMILY + "put_bytes_total",
                        description="Bytes written to the object store by "
                                    "this process"),
                    "get_bytes": Counter(
                        _FAMILY + "get_bytes_total",
                        description="Bytes read from the object store by "
                                    "this process"),
                    "xfer_bytes": Counter(
                        _FAMILY + "transfer_bytes_total",
                        description="Bytes moved between store daemons on "
                                    "behalf of this process",
                        tag_keys=("op",)),
                    "reconnects": Counter(
                        _FAMILY + "client_reconnects_total",
                        description="Store-client redials after a dropped "
                                    "daemon connection (daemon crash/"
                                    "restart recovery)"),
                    "puts": Counter(
                        _FAMILY + "puts_total",
                        description="Object-store puts by data path "
                                    "(zcopy = written directly into the "
                                    "client's shm mapping; streamed = "
                                    "payload over the daemon socket)",
                        tag_keys=("path",)),
                    "prefault_s": Histogram(
                        _FAMILY + "prefault_latency_s",
                        description="Time to pre-fault the client's shm "
                                    "mapping at connect/remap",
                        boundaries=(0.0002, 0.001, 0.005, 0.02, 0.1,
                                    0.5)),
                }
    return _METRICS


class StoreFullError(Exception):
    pass


class ObjectNotFoundError(Exception):
    pass


class ObjectEvictedError(Exception):
    pass


class StoreServer:
    """Owns the store daemon process for a node.

    The daemon is restartable in place: after a crash ``restart()``
    respawns it on the SAME socket path and shm name with a bumped
    ``incarnation`` (the daemon itself shm_unlinks + recreates the
    segment and rebinds the socket at startup, so the identity is
    stable while the contents start empty — the node supervisor pairs
    this with dropping the node's object-directory entries so lineage
    rebuilds what was lost).
    """

    def __init__(self, socket_path: str, shm_name: str, capacity: int,
                 spill_dir: str = "", xfer_host: str = "",
                 cluster_token: str = ""):
        self.socket_path = socket_path
        self.shm_name = shm_name
        self.capacity = capacity
        self.spill_dir = spill_dir
        self.xfer_host = xfer_host
        self._cluster_token = cluster_token
        # bumped by restart(); lets observers tell apart daemon lifetimes
        self.incarnation = 0
        # daemon-to-daemon transfer listener port (0 = disabled)
        self.xfer_port = 0
        self._spawn()

    def _spawn(self):
        args = [binary_path("shm_store"), self.socket_path, self.shm_name,
                str(self.capacity)]
        if self.spill_dir or self.xfer_host:
            args.append(self.spill_dir)
        if self.xfer_host:
            args.append(self.xfer_host)
        env = dict(os.environ)
        if self._cluster_token:
            env["RTPU_STORE_TOKEN"] = self._cluster_token  # env, never argv
        self._proc = subprocess.Popen(
            args,
            stdout=subprocess.PIPE,
            env=env,
        )
        line = self._proc.stdout.readline()
        if b"READY" not in line:
            raise RuntimeError(f"shm_store failed to start: {line!r}")
        parts = line.split()
        self.xfer_port = 0
        if len(parts) > 1:
            try:
                self.xfer_port = int(parts[1])
            except ValueError:
                pass

    def poll(self):
        """Exit code of the daemon process, or None while it is alive."""
        return self._proc.poll()

    def restart(self) -> bool:
        """Respawn a dead daemon on the same socket/shm name.

        Returns True when a new incarnation was started (False when the
        current process is still alive).  Spill files belong to the dead
        incarnation's in-memory index and are unreadable by the new one,
        so they are swept first.
        """
        if self._proc.poll() is None:
            return False
        if self.spill_dir:
            try:
                for name in os.listdir(self.spill_dir):
                    try:
                        os.unlink(os.path.join(self.spill_dir, name))
                    except OSError:
                        pass
            except OSError:
                pass
        self.incarnation += 1
        self._spawn()
        return True

    def shutdown(self):
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        shm_file = f"/dev/shm/{self.shm_name.lstrip('/')}"
        try:
            os.unlink(shm_file)
        except OSError:
            pass


class StoreClient:
    """Thread-safe client: a pool of sockets + two shm mappings.

    Puts write through a read-write mapping of the segment; gets hand out
    views of a read-only mapping of the same pages, so a write into a got
    object (a torch tensor has no read-only flag) faults instead of
    changing the sealed object for every other reader.

    A pool (rather than one mutex-guarded socket) is required because GET can
    block server-side until an object is sealed; a concurrent PUT from
    another thread of the same client must not queue behind it — that would
    deadlock producer/consumer threads sharing a client.
    """

    def __init__(self, socket_path: str, shm_name: str, capacity: int):
        self._socket_path = socket_path
        self._shm_name = shm_name
        self._capacity = capacity
        self._client_id = os.urandom(ID_LEN)  # server-side ref bookkeeping key
        self._closed = False
        self._mm = None
        self._mm_ro = None  # read-only mapping the get views come from
        self._mm_key = None  # (st_dev, st_ino) of the mapped segment
        self._pool_lock = threading.Lock()
        # pool entries: (socket, native StoreConn | None).  The native conn
        # runs the per-op pack/send/recv in C with the GIL released
        # (native/core_worker.cc StoreConn); the Python path remains the
        # fallback when the extension is unavailable or chaos-disabled.
        self._pool: list = [self._dial(timeout=10)]
        shm_file = f"/dev/shm/{shm_name.lstrip('/')}"
        fd = os.open(shm_file, os.O_RDWR)
        try:
            st = os.fstat(fd)
            self._mm = mmap.mmap(fd, capacity)
            self._mm_ro = mmap.mmap(fd, capacity, access=mmap.ACCESS_READ)
            self._mm_key = (st.st_dev, st.st_ino)
        finally:
            os.close(fd)
        self._prefault(self._mm)
        self._prefault(self._mm_ro, write=False)

    @staticmethod
    def _prefault(mm, write: bool = True) -> None:
        """Install PTEs for the mapping's hot prefix once, at map time.

        Without this every zero-copy put/get pays a soft page fault per
        4KB touched (~2560 for a 10MB object) because a fresh mapping
        shares pages with the daemon but not page-table entries.
        MADV_POPULATE_WRITE populates them writable in one syscall
        without altering page contents (safe against concurrent
        writers, unlike touching bytes by hand); kernels without it
        (<5.14) fall back to a read-touch per page, which on tmpfs also
        leaves the PTE usable for the later write.  A read-only mapping
        (``write=False``) takes the read-touch alone."""
        n = min(len(mm), _PREFAULT_BYTES)
        if n <= 0:
            return
        t0 = time.perf_counter()
        populated = False
        adv = getattr(mmap, "MADV_POPULATE_WRITE", None)
        if write and adv is not None:
            try:
                mm.madvise(adv, 0, n)
                populated = True
            except (OSError, ValueError):
                pass
        if write and not populated:
            # This interpreter predates the MADV_POPULATE_* constants;
            # issue the same madvise through libc (value 23 is fixed in
            # the uapi headers).  Kernels < 5.14 answer EINVAL and we
            # fall through to the read-touch loop.
            try:
                import ctypes

                buf = (ctypes.c_char * len(mm)).from_buffer(mm)
                try:
                    libc = ctypes.CDLL(None, use_errno=True)
                    ret = libc.madvise(
                        ctypes.c_void_p(ctypes.addressof(buf)),
                        ctypes.c_size_t(n), 23)  # MADV_POPULATE_WRITE
                    populated = ret == 0
                finally:
                    del buf  # exported pointer would block mm.close()
            except Exception:
                pass
        if not populated:
            # Read-touch installs the page mappings (cheap) but the
            # first write per page still pays a dirtying fault.
            try:
                import numpy as np

                np.frombuffer(mm, dtype=np.uint8,
                              count=n)[:: mmap.PAGESIZE].max()
            except Exception:
                mv = memoryview(mm)
                for off in range(0, n, mmap.PAGESIZE):
                    mv[off]
                mv.release()
        try:
            _metrics()["prefault_s"].observe(time.perf_counter() - t0)
        except Exception:
            pass  # metrics must never break connect

    def _dial(self, timeout: float = 2.0):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        deadline = time.monotonic() + timeout
        while True:
            try:
                sock.connect(self._socket_path)
                sock.sendall(self._client_id)  # handshake
                break
            except OSError:
                sock.close()
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # a successful connect proves the live daemon's segment exists:
        # refresh the mapping if a restart replaced it underneath us
        self._maybe_remap()
        nc = None
        core = _native_core()
        if core is not None:
            nc = core.StoreConn(sock.fileno())
        return sock, nc

    def _flush_pool(self):
        """Drop every pooled connection (they all point at a daemon that
        just went away; fresh ops redial)."""
        with self._pool_lock:
            entries, self._pool = self._pool, []
        for sock, _ in entries:
            try:
                sock.close()
            except OSError:
                pass

    def _maybe_remap(self):
        """After a daemon restart the shm segment is a NEW inode: remap so
        new views land in the live segment.  Views handed out earlier keep
        the old mapping alive through their buffer references, so replacing
        ``self._mm`` never invalidates them."""
        if self._mm is None:
            return  # still constructing; __init__ maps explicitly
        shm_file = f"/dev/shm/{self._shm_name.lstrip('/')}"
        try:
            st = os.stat(shm_file)
        except OSError:
            return  # segment not recreated yet; the retry loop returns here
        if (st.st_dev, st.st_ino) == self._mm_key:
            return
        try:
            fd = os.open(shm_file, os.O_RDWR)
            try:
                mm = mmap.mmap(fd, self._capacity)
                mm_ro = mmap.mmap(fd, self._capacity,
                                  access=mmap.ACCESS_READ)
            finally:
                os.close(fd)
        except (OSError, ValueError):
            return  # racing the daemon's ftruncate; retried next attempt
        self._prefault(mm)  # re-fault: the new segment's pages are cold
        self._prefault(mm_ro, write=False)
        self._mm, self._mm_ro = mm, mm_ro
        self._mm_key = (st.st_dev, st.st_ino)

    def _with_retry(self, attempt, what: str):
        """Run one store op, transparently redialing through daemon
        restarts.

        ``attempt(first)`` performs the op on a pooled/fresh connection and
        raises ConnectionError/OSError on transport failure (both the
        Python socket path and the native StoreConn do).  On failure every
        pooled connection is flushed and the op retried with backoff until
        the RTPU_STORE_RETRY_S budget, after which StoreDiedError
        surfaces — tasks treat that like a worker crash (retry + lineage)
        rather than a poisoned worker.
        """
        deadline = None
        delay = 0.05
        first = True
        while True:
            try:
                return attempt(first)
            except StoreDiedError:
                raise
            except (ConnectionError, OSError) as e:
                self._flush_pool()
                try:
                    _metrics()["reconnects"].inc()
                except Exception:
                    pass  # metrics must never break recovery (teardown)
                if os.environ.get("RTPU_TESTING_STORE_FAILURE"):
                    # Chaos attribution for the store lane: the injection
                    # itself lives in the C++ daemon (shm_store.cc), so
                    # the Python-side observer of its effect — a forced
                    # reconnect while the flag is armed — is what puts
                    # the incident on the `rtpu events` timeline.
                    try:
                        from ray_tpu_torch.util import events

                        events.emit(
                            "chaos.store", severity="warning",
                            message=f"store connection lost during {what} "
                                    "with RTPU_TESTING_STORE_FAILURE "
                                    "armed",
                            data={"op": what}, coalesce_s=1.0)
                    except Exception:
                        pass
                if self._closed:
                    raise
                now = time.monotonic()
                if deadline is None:
                    deadline = now + _RETRY_BUDGET_S
                elif now >= deadline:
                    raise StoreDiedError(
                        f"object store daemon unreachable for {what} "
                        f"after {_RETRY_BUDGET_S:.1f}s retry budget"
                    ) from e
                time.sleep(delay)
                delay = min(delay * 2, 0.5)
                first = False

    @staticmethod
    def _oid20(oid: bytes) -> bytes:
        # struct's "20s" silently truncates/pads; keep that behavior for
        # the native path too
        return oid if len(oid) == ID_LEN else oid[:ID_LEN].ljust(ID_LEN,
                                                                 b"\x00")

    def _checkout(self):
        with self._pool_lock:
            entry = self._pool.pop() if self._pool else None
        return entry if entry is not None else self._dial()

    def _checkin(self, entry):
        with self._pool_lock:
            if len(self._pool) < _POOL_MAX:
                self._pool.append(entry)
                return
        entry[0].close()

    @staticmethod
    def _recv_exact(sock, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("object store connection closed")
            buf += chunk
        return buf

    def _call_once(self, op: int, oid: bytes, arg0: int = 0, arg1: int = 0):
        entry = self._checkout()
        sock, nc = entry
        try:
            if nc is not None:
                out = nc.call(op, self._oid20(oid), arg0, arg1)
            else:
                sock.sendall(_REQ.pack(op, oid, arg0, arg1))
                out = _RESP.unpack(self._recv_exact(sock, _RESP.size))
        except BaseException:
            sock.close()
            raise
        self._checkin(entry)
        return out

    def _call(self, op: int, oid: bytes, arg0: int = 0, arg1: int = 0):
        return self._with_retry(
            lambda first: self._call_once(op, oid, arg0, arg1),
            f"op{op}")

    def create(self, oid: bytes, size: int) -> memoryview:
        """Allocate space; returns a writable view. Must seal() after writing."""
        def attempt(first):
            status, offset, _ = self._call_once(_OP_CREATE, oid, size)
            if status == ST_EXISTS and not first:
                # A dropped connection after the daemon applied CREATE
                # leaves our own unsealed extent behind; reclaim and
                # re-create.  Abort refuses (ST_ERR) on a genuinely sealed
                # object, so the re-create still reports EXISTS for those.
                self._call_once(_OP_ABORT, oid)
                status, offset, _ = self._call_once(_OP_CREATE, oid, size)
            return status, offset

        status, offset = self._with_retry(attempt, "create")
        if status == ST_OOM:
            raise StoreFullError(f"object store full allocating {size} bytes")
        if status == ST_EXISTS:
            raise FileExistsError(f"object {oid.hex()} already exists")
        if status != ST_OK:
            raise RuntimeError(f"create failed: {_status_name(status)}")
        return memoryview(self._mm)[offset : offset + size]

    def seal(self, oid: bytes):
        status, _, _ = self._call(_OP_SEAL, oid)
        if status != ST_OK:
            raise RuntimeError(f"seal failed: {_status_name(status)}")

    @staticmethod
    def _byte_parts(parts) -> list:
        """Normalize payload parts to flat byte views without copying:
        buffer-protocol objects become ``memoryview(...).cast('B')``
        (non-contiguous ones pay the unavoidable flattening copy)."""
        out = []
        for p in parts:
            if not isinstance(p, (bytes, bytearray)):
                try:
                    p = memoryview(p).cast("B")
                except TypeError:
                    p = bytes(p)
            out.append(p)
        return out

    def _put_zcopy(self, oid: bytes, parts: list, total: int) -> int:
        """create → write into the client's own mapping → seal.  No
        payload bytes on the socket; the two control round trips are
        noise at these sizes.  Parts must already be flat byte views
        (``_byte_parts``) so the write loop is pure slice assignment.

        Composes with the restart path: each retry redials (which
        remaps onto a restarted daemon's fresh segment), so the write
        always lands in the mapping the CREATE's offset belongs to.  A
        seal that comes back non-OK after our own successful create
        means the daemon restarted between the two round trips — the
        offset belongs to a dead incarnation — so it is re-raised as a
        transport failure for the retry loop to redo cleanly."""
        def attempt(first):
            status, offset, _ = self._call_once(_OP_CREATE, oid, total)
            if status == ST_EXISTS and not first:
                # A dropped connection after the daemon applied CREATE
                # leaves our own unsealed extent behind; reclaim and
                # re-create.  Abort refuses (ST_ERR) on a genuinely
                # sealed object, so a second EXISTS means the lost
                # reply's put actually committed.
                self._call_once(_OP_ABORT, oid)
                status, offset, _ = self._call_once(_OP_CREATE, oid,
                                                    total)
                if status == ST_EXISTS:
                    return ST_OK
            if status != ST_OK:
                return status
            try:
                dst = memoryview(self._mm)
                pos = offset
                for p in parts:
                    n = len(p)
                    dst[pos : pos + n] = p
                    pos += n
                dst.release()
            except BaseException:
                try:
                    self._call_once(_OP_ABORT, oid)
                except (OSError, ValueError):
                    pass  # never leave a husk behind a failed write
                raise
            status, _, _ = self._call_once(_OP_SEAL, oid)
            if status != ST_OK:
                raise ConnectionError(
                    f"store restarted mid-put (seal {_status_name(status)})")
            return ST_OK

        return self._with_retry(attempt, "put")

    def put(self, oid: bytes, data) -> None:
        """Store ``data`` under ``oid``.

        Large payloads (>= RTPU_ZCOPY_PUT_MIN) take the zero-copy path:
        create + seal control round trips with the bytes written
        directly into the shared mapping.  Small ones use OP_PUT — one
        daemon round trip with the payload on the request stream; two
        round trips (create, seal) were 83% of a small put's cost, each
        being a client<->daemon context switch on a 1-core host.

        Buffer-protocol inputs (arrays, views) are never copied up
        front: they are wrapped as views and sized via nbytes, so the
        old eager ``bytes(data)`` double-buffer is gone."""
        if not isinstance(data, (bytes, bytearray, memoryview)):
            try:
                data = memoryview(data)
            except TypeError:
                data = bytes(data)  # no buffer protocol: must materialize
        if isinstance(data, memoryview) and (data.itemsize != 1
                                             or data.ndim != 1):
            try:
                data = data.cast("B")
            except TypeError:
                data = bytes(data)  # non-contiguous: flattening copy
        size = len(data)
        if size >= ZCOPY_PUT_MIN:
            t0 = time.perf_counter()
            self._finish_put(self._put_zcopy(oid, [data], size), size,
                             "zcopy", t0, oid)
            return

        def attempt(first):
            entry = self._checkout()
            sock, nc = entry
            try:
                if nc is not None:
                    status = nc.put(self._oid20(oid), data)
                else:
                    req = _REQ.pack(_OP_PUT, oid, len(data), 0)
                    if len(data) <= 65536:
                        sock.sendall(req + bytes(data))  # one syscall
                    else:
                        sock.sendall(req)
                        sock.sendall(data)
                    status, _, _ = _RESP.unpack(
                        self._recv_exact(sock, _RESP.size))
            except BaseException:
                sock.close()
                raise
            self._checkin(entry)
            if status == ST_EXISTS and not first:
                # the lost reply's PUT committed before the conn dropped
                status = ST_OK
            return status

        t0 = time.perf_counter()
        status = self._with_retry(attempt, "put")
        self._finish_put(status, size, "streamed", t0, oid)

    def _finish_put(self, status: int, total: int, path: str,
                    t0: float, oid: bytes = b"") -> None:
        """Shared put epilogue: raise on failure statuses, record the
        latency/bytes metrics and the per-data-path put counter."""
        if status == ST_OOM:
            raise StoreFullError(
                f"object store full allocating {total} bytes")
        if status == ST_EXISTS:
            raise FileExistsError(f"object {oid.hex()} already exists")
        if status != ST_OK:
            raise RuntimeError(f"put failed: {_status_name(status)}")
        try:
            m = _metrics()
            m["put_lat"].observe(time.perf_counter() - t0)
            m["put_bytes"].inc(total)
            m["puts"].inc(tags={"path": path})
        except Exception:
            pass  # metrics must never fail a committed put

    def put_parts(self, oid: bytes, parts, total: int) -> None:
        """Vectored put: parts are stored without client-side scratch
        assembly.

        At or above RTPU_ZCOPY_PUT_MIN the parts are written directly
        into the client's shm mapping between create and seal (zero
        payload bytes on the socket).  Below it they stream onto the
        OP_PUT request and the daemon's per-connection thread copies
        them into the fresh extent outside the store lock."""
        parts = self._byte_parts(parts)  # replayable across retries
        if total >= ZCOPY_PUT_MIN:
            t0 = time.perf_counter()
            self._finish_put(self._put_zcopy(oid, parts, total), total,
                             "zcopy", t0, oid)
            return

        def attempt(first):
            entry = self._checkout()
            sock, nc = entry
            try:
                # bypass the native conn's single-buffer put: sendall on the
                # same fd keeps framing; the conn is checked out exclusively
                sock.sendall(_REQ.pack(_OP_PUT, oid, total, 0))
                for part in parts:
                    sock.sendall(part)
                status, _, _ = _RESP.unpack(
                    self._recv_exact(sock, _RESP.size))
            except BaseException:
                sock.close()
                raise
            self._checkin(entry)
            if status == ST_EXISTS and not first:
                status = ST_OK  # committed before the conn dropped
            return status

        t0 = time.perf_counter()
        status = self._with_retry(attempt, "put")
        self._finish_put(status, total, "streamed", t0, oid)

    def _transfer_op(self, op: int, oid: bytes, addr: str):
        """OP_PULL / OP_PUSH: ask the local daemon to move oid between its
        segment and the peer daemon at ``addr`` ("host:port") — the data
        plane never touches this process (see shm_store.cc transfer
        plane).  Returns (status, size)."""
        payload = addr.encode("utf-8")

        def attempt(first):
            entry = self._checkout()
            sock, nc = entry
            try:
                sock.sendall(_REQ.pack(op, oid, len(payload), 0) + payload)
                status, _, size = _RESP.unpack(
                    self._recv_exact(sock, _RESP.size))
            except BaseException:
                sock.close()
                raise
            self._checkin(entry)
            return status, size

        t0 = time.perf_counter()
        status, size = self._with_retry(attempt, "transfer")
        try:
            m = _metrics()
            m["xfer_lat"].observe(time.perf_counter() - t0)
            if status == ST_OK:
                m["xfer_bytes"].inc(size, tags={
                    "op": "pull" if op == _OP_PULL else "push"})
        except Exception:
            pass
        return status, size

    def pull_remote(self, oid: bytes, addr: str) -> bool:
        """Pull oid from the peer store daemon at addr into the local
        store (daemon-to-daemon stream).  True when the object is local
        (pulled now or already present) and sealed."""
        status, _ = self._transfer_op(_OP_PULL, oid, addr)
        return status == ST_OK

    def push_remote(self, oid: bytes, addr: str) -> bool:
        """Push a locally-sealed oid to the peer store daemon at addr.
        True when the peer holds the object afterwards (streamed now, or
        it already had a copy)."""
        status, _ = self._transfer_op(_OP_PUSH, oid, addr)
        return status == ST_OK

    def get_bytes(self, oid: bytes, timeout_ms: int = 0):
        """Like get() but always ONE round trip: small objects come back
        as bytes with NO pin (nothing to release); larger objects answer
        ST_VIEW with the pin kept and (offset, size), mapped here into
        the usual zero-copy view.

        Returns bytes | memoryview | None.  Callers must only release()
        when the result is a memoryview.
        """
        def attempt(first):
            entry = self._checkout()
            sock, nc = entry
            try:
                if nc is not None:
                    status, inline, size, data = nc.get_inline(
                        self._oid20(oid), timeout_ms, INLINE_GET_MAX)
                else:
                    sock.sendall(
                        _REQ.pack(_OP_GET_INLINE, oid, timeout_ms,
                                  INLINE_GET_MAX))
                    status, inline, size = _RESP.unpack(
                        self._recv_exact(sock, _RESP.size))
                    data = (self._recv_exact(sock, size)
                            if status == ST_OK and inline == 1 else None)
            except BaseException:
                sock.close()
                raise
            self._checkin(entry)
            return status, inline, size, data

        t0 = time.perf_counter()
        status, inline, size, data = self._with_retry(attempt, "get")
        if status in (ST_NOT_FOUND, ST_NOT_SEALED, ST_TIMEOUT):
            return None
        if status == ST_EVICTED:
            raise ObjectEvictedError(
                f"object {oid.hex()[:12]} was evicted from the store")
        if status == ST_VIEW:  # pinned view handed back in-round-trip
            m = _metrics()
            m["get_lat"].observe(time.perf_counter() - t0)
            m["get_bytes"].inc(size)
            return memoryview(self._mm_ro)[inline : inline + size]
        if status != ST_OK:
            raise RuntimeError(f"get failed: {_status_name(status)}")
        if inline:
            m = _metrics()
            m["get_lat"].observe(time.perf_counter() - t0)
            m["get_bytes"].inc(len(data))
            return data
        return self.get(oid, timeout_ms)

    def get(self, oid: bytes, timeout_ms: int = 0):
        """Return a zero-copy memoryview of a sealed object, or None.

        With timeout_ms == 0 this is a non-blocking probe; otherwise blocks in
        the store until the object is sealed or the timeout elapses.  The view
        pins the object (refcount) until ``release``.
        """
        t0 = time.perf_counter()
        status, offset, size = self._call(_OP_GET, oid, timeout_ms)
        if status in (ST_NOT_FOUND, ST_NOT_SEALED, ST_TIMEOUT):
            return None
        if status == ST_EVICTED:
            raise ObjectEvictedError(
                f"object {oid.hex()[:12]} was evicted from the store")
        if status != ST_OK:
            raise RuntimeError(f"get failed: {_status_name(status)}")
        m = _metrics()
        m["get_lat"].observe(time.perf_counter() - t0)
        m["get_bytes"].inc(size)
        return memoryview(self._mm_ro)[offset : offset + size]

    def release(self, oid: bytes):
        # Advisory unpin: zero-copy array views release via GC finalizers,
        # which can outlive the store daemon at interpreter exit — a dead
        # socket just means there is nothing left to unpin.  Single
        # attempt, no reconnect loop: a finalizer must never stall for the
        # retry budget, and a restarted daemon has no pin to drop anyway.
        try:
            self._call_once(_OP_RELEASE, oid)
        except (OSError, ValueError):
            pass

    def delete(self, oid: bytes):
        self._call(_OP_DELETE, oid)

    def abort(self, oid: bytes):
        self._call(_OP_ABORT, oid)

    def contains(self, oid: bytes) -> bool:
        status, sealed, _ = self._call(_OP_CONTAINS, oid)
        return status == ST_OK and sealed == 1

    def stats(self) -> dict:
        _, used, num_objects = self._call(_OP_STATS, b"\x00" * ID_LEN)
        return {"used_bytes": used, "num_objects": num_objects}

    def audit(self, max_rows: int = 10000,
              max_tombstones: int = 4096) -> dict:
        """Point-in-time store audit: occupancy/fragmentation summary,
        one row per resident/spilled object (size, seal state, pin count,
        create age, idle time), and the newest eviction tombstones.

        Variable-length response, so it bypasses the native conn's
        fixed-frame ``call`` and speaks the wire protocol directly on the
        checked-out socket (the ``put_parts`` idiom)."""

        def attempt(first):
            entry = self._checkout()
            sock, nc = entry
            try:
                sock.sendall(_REQ.pack(_OP_AUDIT, b"\x00" * ID_LEN,
                                       max_rows, max_tombstones))
                status, length, _ = _RESP.unpack(
                    self._recv_exact(sock, _RESP.size))
                if status != ST_OK:
                    raise RuntimeError(f"audit failed: {_status_name(status)}")
                payload = self._recv_exact(sock, length)
            except BaseException:
                sock.close()
                raise
            self._checkin(entry)
            return payload

        payload = self._with_retry(attempt, "audit")
        doc = json.loads(payload.decode("utf-8"))
        s = doc.get("summary", {})
        cap = s.get("capacity") or 1
        # derived gauges computed client-side so every surface (metrics,
        # dashboard, CLI) agrees on the arithmetic
        s["occupancy"] = s.get("used", 0) / cap
        free = max(cap - s.get("used", 0), 0)
        s["fragmentation"] = (
            1.0 - s.get("largest_free", 0) / free if free else 0.0)
        return doc

    def close(self):
        self._closed = True  # in-flight retries surface instead of spinning
        self._flush_pool()
