"""Length-prefixed message framing over unix sockets.

Control-plane counterpart of the reference's gRPC wrappers
(Ray's src/ray/rpc/) scaled to the in-node runtime: messages are
pickled dicts with a 4-byte length prefix.  The data plane never flows through
here — objects move via the shared-memory store (store_client.py).

Fault injection (reference: RAY_testing_rpc_failure, src/ray/rpc/
rpc_chaos.h:23): set ``RTPU_TESTING_RPC_FAILURE="<send%>:<recv%>"`` (e.g.
"5:5") and that percentage of sends/receives raises ConnectionResetError at
this layer — exercising every retry/failover path without killing
processes. Inherited by workers via the environment, so one env var chaoses
the whole cluster.
"""

from __future__ import annotations

import os
import pickle
import random
import socket
import struct
import threading

from ray_tpu_torch._private.wire_constants import MAX_FRAME

_LEN = struct.Struct("<I")


def _parse_chaos() -> tuple[float, float, dict]:
    """Parse RTPU_TESTING_RPC_FAILURE.

    Two forms, combinable comma-separated (reference:
    RAY_testing_rpc_failure, src/ray/rpc/rpc_chaos.h:23 — per-method scoped
    failures with max counts):

      "<send%>:<recv%>"                   — global, every frame
      "<method>=<max>:<req%>:<resp%>"     — scoped to one RPC method; at
                                            most <max> failures are ever
                                            injected for it ("*" matches
                                            any method; max -1 = unlimited)
    """
    glob_send = glob_recv = 0.0
    methods: dict = {}
    for part in os.environ.get("RTPU_TESTING_RPC_FAILURE", "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            if "=" in part:
                name, _, rest = part.partition("=")
                max_s, req_s, resp_s = (rest.split(":") + ["0", "0"])[:3]
                methods[name] = [int(max_s or 0), float(req_s or 0) / 100.0,
                                 float(resp_s or 0) / 100.0]
            else:
                send_s, _, recv_s = part.partition(":")
                glob_send = float(send_s or 0) / 100.0
                glob_recv = float(recv_s or 0) / 100.0
        except ValueError:
            continue
    return glob_send, glob_recv, methods


_CHAOS_SEND, _CHAOS_RECV, _CHAOS_METHODS = _parse_chaos()
_chaos_rng = random.Random(os.environ.get("RTPU_TESTING_RPC_SEED"))
_chaos_lock = threading.Lock()


def chaos_should_fail(method: str, direction: str) -> bool:
    """Method-aware injection point (direction: "req" | "resp").

    Called by method-aware RPC layers (GcsClient, worker/scheduler rpc)
    around each call; the frame-level global rates stay in Connection.
    Each scoped entry injects at most its max_failures failures total in
    this process, which is what lets a test say "drop the first 2 lease
    responses" and then observe recovery.
    """
    entry = _CHAOS_METHODS.get(method) or _CHAOS_METHODS.get("*")
    if entry is None:
        return False
    with _chaos_lock:
        remaining, req_p, resp_p = entry
        if remaining == 0:
            return False
        p = req_p if direction == "req" else resp_p
        if p and _chaos_rng.random() < p:
            if remaining > 0:
                entry[0] = remaining - 1
            _note_chaos_event(f"method {method} {direction}")
            return True
    return False


def _note_chaos_event(detail: str) -> None:
    """RTPU_TESTING_RPC_FAILURE injections go on the cluster event plane
    so chaos-test incidents are attributable on the `rtpu events`
    timeline.  Buffered + coalesced, never flushed inline: the flush
    path itself traverses this transport (emit's thread-local guard
    breaks the recursion; coalescing keeps frame-rate chaos to <=1
    event/s on the wire)."""
    try:
        from ray_tpu_torch.util import events

        events.emit("chaos.rpc", severity="warning",
                    message=f"injected RPC failure: {detail}",
                    data={"detail": detail}, coalesce_s=1.0)
    except Exception:
        pass


class ProtocolError(ConnectionError):
    """A frame that violates the connection's dialect (e.g. a raw binary
    raylet-lane frame arriving on a pickled request/response connection)."""


class Connection:
    """A framed, thread-safe-for-send message connection."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._send_lock = threading.Lock()

    def send(self, msg: dict):
        if _CHAOS_SEND and _chaos_rng.random() < _CHAOS_SEND:
            # An injected "reset" must BE a reset: close the socket so the
            # peer observes EOF and runs its death/repair path.  Raising
            # without closing would simulate a dropped frame on a healthy
            # connection — a failure mode lease-less dispatch paths cannot
            # detect (the task would hang in in_flight forever).
            self.close()
            _note_chaos_event("connection send")
            raise ConnectionResetError("rpc chaos: injected send failure")
        data = pickle.dumps(msg, protocol=5)
        frame = _LEN.pack(len(data)) + data
        with self._send_lock:
            self.sock.sendall(frame)

    def recv(self) -> dict | None:
        """Receive one pickled message; None on clean EOF.  A binary
        (raw-dialect) frame on a pickled-dialect connection is a protocol
        violation — raise, never map it to the EOF sentinel (callers such
        as state.py / client.py treat None as a clean hang-up and would
        silently drop the request)."""
        kind, msg = self.recv_any()
        if kind == "raw":
            raise ProtocolError(
                "unexpected binary frame on a pickled-dialect connection")
        return msg if kind == "msg" else None

    def recv_any(self):
        """Receive one message of EITHER dialect: ("msg", dict) for
        pickled frames (first byte 0x80, the pickle protocol marker),
        ("raw", bytes) for binary node-service frames (0x10-0x13 raylet
        lane), or (None, None) on clean EOF."""
        if _CHAOS_RECV and _chaos_rng.random() < _CHAOS_RECV:
            # raise (not clean-EOF None): dispatch loops must hit their
            # error/crash-recovery paths, not their graceful-shutdown path
            _note_chaos_event("connection recv")
            raise ConnectionResetError("rpc chaos: injected recv failure")
        header = self._recv_exact(_LEN.size)
        if header is None:
            return None, None
        (length,) = _LEN.unpack(header)
        body = self._recv_exact(length)
        if body is None:
            return None, None
        if body[:1] == b"\x80":
            return "msg", pickle.loads(body)
        return "raw", body

    def send_bytes(self, data: bytes):
        """Send one raw frame (no pickling) — pre-auth handshakes."""
        frame = _LEN.pack(len(data)) + data
        with self._send_lock:
            self.sock.sendall(frame)

    def send_frame(self, data: bytes):
        """Send one raw frame WITH chaos injection — wire-codec RPCs."""
        if _CHAOS_SEND and _chaos_rng.random() < _CHAOS_SEND:
            self.close()  # a reset, not a silent drop (see send())
            raise ConnectionResetError("rpc chaos: injected send failure")
        self.send_bytes(data)

    def recv_frame(self, max_len: int = MAX_FRAME) -> bytes | None:
        """Receive one raw frame WITH chaos injection; None on EOF.

        The wire-codec counterpart of recv(): nothing is unpickled — the
        caller decodes with wire.decode, which cannot execute code.
        Oversize frames raise ValueError (NOT None): None means the peer
        hung up and retrying is safe, which is false for oversize."""
        if _CHAOS_RECV and _chaos_rng.random() < _CHAOS_RECV:
            _note_chaos_event("connection recv_raw")
            raise ConnectionResetError("rpc chaos: injected recv failure")
        header = self._recv_exact(_LEN.size)
        if header is None:
            return None
        (length,) = _LEN.unpack(header)
        if length > max_len:
            raise ValueError(
                f"frame of {length} bytes exceeds the {max_len}-byte cap")
        return self._recv_exact(length)

    def recv_bytes(self, max_len: int = 1 << 16) -> bytes | None:
        """Receive one raw frame WITHOUT unpickling; None on EOF/oversize.

        The untrusted-peer path: nothing the remote sent is interpreted
        beyond the length prefix, so it is safe to call before a connection
        has authenticated.
        """
        header = self._recv_exact(_LEN.size)
        if header is None:
            return None
        (length,) = _LEN.unpack(header)
        if length > max_len:
            return None
        return self._recv_exact(length)

    def _recv_exact(self, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except (ConnectionResetError, OSError):
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def close(self):
        # shutdown() before close(): close() alone does NOT wake a thread
        # blocked in recv() on this socket (the fd just leaks out from
        # under it) — shutdown() delivers EOF to blocked readers, so
        # reader loops run their death/repair paths promptly.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def connect(path: str) -> Connection:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(path)
    return Connection(s)


def listener(path: str) -> socket.socket:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(path)
    s.listen(512)
    return s


def connect_tcp(host: str, port: int, timeout: float = 10.0) -> Connection:
    """TCP variant (remote drivers — the client proxy, util/client)."""
    s = socket.create_connection((host, port), timeout=timeout)
    s.settimeout(None)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return Connection(s)


def listener_tcp(host: str = "0.0.0.0", port: int = 0) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.listen(128)
    return s


# ---------------------------------------------------------------------------
# Address strings.  Every service endpoint in the cluster (GCS, scheduler,
# per-worker servers) is named by one string that is either a unix socket
# path ("/tmp/ray_tpu/session_x/sched.sock" — same-host, zero config) or a
# "host:port" TCP endpoint (multi-host clusters).  The reference's analogue
# is gRPC target strings (src/ray/rpc/); keeping both transports behind one
# connect/listen pair lets the whole control plane switch to TCP per-node.
#
# TCP security: every frame on these connections is unpickled, so a TCP
# connection must prove membership before its first frame is parsed — a
# raw (never-unpickled) cluster-token handshake, same mechanism as the
# rtpu:// client server.  The token lives in RTPU_CLUSTER_TOKEN: the head
# generates one when it binds TCP, worker nodes/processes inherit it via
# the environment (or a "token@host:port" address).  Unix-socket
# connections skip the handshake — they are same-host and guarded by
# filesystem permissions, like the reference's raylet socket.
# ---------------------------------------------------------------------------

_TOKEN_ENV = "RTPU_CLUSTER_TOKEN"


def cluster_token() -> str:
    return os.environ.get(_TOKEN_ENV, "")


def ensure_cluster_token() -> str:
    """Generate (and export for child processes) a token if none is set."""
    tok = os.environ.get(_TOKEN_ENV)
    if not tok:
        import secrets

        tok = secrets.token_hex(16)
        os.environ[_TOKEN_ENV] = tok
    return tok


def split_token_addr(addr: str) -> tuple[str | None, str]:
    """Parse "token@host:port" -> (token, "host:port"); no token -> None."""
    if "@" in addr and not addr.startswith("/"):
        token, _, rest = addr.rpartition("@")
        return token, rest
    return None, addr


def is_tcp_addr(addr: str) -> bool:
    if addr.startswith("/") or addr.startswith("."):
        return False
    host, _, port = addr.rpartition(":")
    return bool(host) and port.isdigit()


def connect_addr(addr: str, timeout: float = 10.0) -> Connection:
    """Connect to a unix-path or host:port address.

    TCP connections perform the cluster-token handshake before returning,
    so callers never talk to a listener they can't authenticate to."""
    token, addr = split_token_addr(addr)
    if is_tcp_addr(addr):
        host, _, port = addr.rpartition(":")
        conn = connect_tcp(host.strip("[]"), int(port), timeout=timeout)
        tok = token if token is not None else cluster_token()
        try:
            conn.send_bytes(tok.encode("utf-8"))
            if conn.recv_bytes() != b"OK":
                conn.close()
                raise ConnectionRefusedError(
                    f"cluster-token handshake rejected by {addr} (set "
                    f"{_TOKEN_ENV} to the head's token)")
        except OSError:
            conn.close()
            raise
        return conn
    return connect(addr)


def authenticate_server_side(conn: Connection, is_tcp: bool) -> bool:
    """Server half of the handshake; call before the first recv().

    Returns False (connection closed) on mismatch.  Unix connections are
    exempt (same-host, filesystem-guarded)."""
    if not is_tcp:
        return True
    import hmac

    raw = conn.recv_bytes()
    if raw is None or not hmac.compare_digest(
            raw, cluster_token().encode("utf-8")):
        try:
            conn.send_bytes(b"NO")
        except OSError:
            pass
        conn.close()
        return False
    try:
        conn.send_bytes(b"OK")
    except OSError:
        conn.close()
        return False
    return True


def advertised_host(host: str) -> str:
    """A connectable form of a bind host (0.0.0.0/:: -> this host's IP)."""
    if host in ("0.0.0.0", "::", ""):
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"
    return host


def listener_addr(addr: str) -> tuple[socket.socket, str]:
    """Listen on a unix-path or host:port address.

    Returns (socket, advertised_addr): for TCP the advertised address
    carries the kernel-assigned port and a connectable host (a wildcard
    bind is rewritten — "0.0.0.0:p" is not dialable from peers).
    """
    if is_tcp_addr(addr):
        host, _, port = addr.rpartition(":")
        s = listener_tcp(host.strip("[]"), int(port))
        return s, f"{advertised_host(host)}:{s.getsockname()[1]}"
    return listener(addr), addr
