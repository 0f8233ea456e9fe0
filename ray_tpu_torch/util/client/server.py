"""ClientServer: the cluster-side proxy for remote drivers.

Counterpart of Ray's python/ray/util/client/server/server.py —
scope note: all clients share this server's single attached-driver context
(the reference proxies a worker PER client, util/client/server/proxier.py;
one shared driver is the deliberate first cut here and is safe because the
runtime's submission paths are thread-safe).
"""

from __future__ import annotations

import hmac
import secrets
import threading
import traceback
from typing import Optional

import cloudpickle

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.core.object_ref import ObjectRef


class ClientServer:
    """Serve remote drivers on TCP. Must run in a process already attached
    to the cluster (ray_tpu_torch.init done).

    Every op the server executes deserializes client-supplied pickles in the
    cluster-attached driver process, so connections are authenticated: the
    client must present ``token`` (auto-generated when not given; see
    ``self.address``) before any other op is accepted.  Pass ``token=""`` to
    disable authentication — only do that on a trusted, isolated network.
    The listener binds loopback by default; binding a routable interface is
    an explicit opt-in.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token: Optional[str] = None):
        if worker_mod.global_worker_or_none() is None:
            raise RuntimeError("ClientServer requires ray_tpu_torch.init() first")
        self.host = host
        self.token = secrets.token_hex(16) if token is None else token
        self._listener = protocol.listener_tcp(host, port)
        self.port = self._listener.getsockname()[1]
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="client-server", daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        """Connect string for ray_tpu_torch.init (embeds the auth token).

        A wildcard bind is rewritten to this host's routable address, since
        "0.0.0.0" is not connectable from anywhere.
        """
        host = self.host
        if host in ("0.0.0.0", "::", ""):
            import socket as _socket
            try:
                host = _socket.gethostbyname(_socket.gethostname())
            except OSError:
                host = "127.0.0.1"
        if self.token:
            return f"rtpu://{self.token}@{host}:{self.port}"
        return f"rtpu://{host}:{self.port}"

    def _accept_loop(self):
        while not self._shutdown:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = protocol.Connection(sock)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: protocol.Connection):
        ctx = worker_mod.global_worker()
        # First frame is the raw (never unpickled) token handshake: until it
        # matches, no byte from this peer reaches pickle.loads.
        raw = conn.recv_bytes()
        if raw is None:
            conn.close()
            return
        if self.token and not hmac.compare_digest(
                raw, self.token.encode("utf-8")):
            try:
                conn.send_bytes(b"NO")
            except OSError:
                pass
            conn.close()
            return
        try:
            conn.send_bytes(b"OK")
        except OSError:
            conn.close()
            return
        while True:
            msg = conn.recv()
            if msg is None:
                return
            try:
                result = self._handle(ctx, msg)
                conn.send({"ok": True, "result": result})
            except BaseException as e:  # noqa: BLE001 — ship to client
                try:
                    payload = cloudpickle.dumps(e)
                except Exception:
                    payload = cloudpickle.dumps(
                        RuntimeError(f"{type(e).__name__}: {e}"))
                try:
                    conn.send({"ok": False, "error": payload,
                               "traceback": traceback.format_exc()})
                except OSError:
                    return

    def _handle(self, ctx, msg: dict):
        op = msg["op"]
        if op == "put":
            value = cloudpickle.loads(msg["blob"])
            return ctx.put_object(value, oid=msg.get("oid")).binary()
        if op == "get":
            value = ctx.get_object(ObjectRef(msg["oid"]),
                                   timeout=msg.get("timeout"))
            return cloudpickle.dumps(value)
        if op == "register_function":
            fn = cloudpickle.loads(msg["blob"])
            return ctx.register_function(fn)
        if op == "submit":
            ctx.submit(msg["spec"])
            return True
        if op == "rpc":
            return ctx.rpc(msg["method"], msg["params"])
        if op == "wait":
            ready, pending = ctx.wait(
                [ObjectRef(o) for o in msg["oids"]],
                msg["num_returns"], msg.get("timeout"),
                msg.get("fetch_local", True))
            return ([r.binary() for r in ready],
                    [p.binary() for p in pending])
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown client op {op!r}")

    def shutdown(self):
        self._shutdown = True
        try:
            self._listener.close()
        except OSError:
            pass
