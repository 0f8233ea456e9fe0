"""Client-side driver context: WorkerContext over one TCP connection.

Counterpart of Ray's python/ray/util/client/worker.py — but where
the reference re-implements a parallel API surface with proxy classes, here
the client context satisfies the same interface the in-cluster
WorkerContext does (put_object/get_object/submit/rpc/register_function), so
``ray_tpu_torch.remote``/``ActorClass``/state API run over it untouched.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import cloudpickle

from ray_tpu_torch._private import protocol
from ray_tpu_torch.core.object_ref import ObjectRef


class ClientContext:
    mode = "client"

    def __init__(self, host: str, port: int, token: Optional[str] = None):
        import os

        self._conn = protocol.connect_tcp(host, port)
        self._lock = threading.Lock()  # one in-flight request at a time
        self.worker_id = b"client"
        self.node = None
        self._fn_cache: dict[int, tuple[object, bytes]] = {}
        self._tls = threading.local()
        if token is None:
            token = os.environ.get("RTPU_CLIENT_TOKEN", "")
        # Raw-frame handshake (mirrors the server: no pickle pre-auth).
        self._conn.send_bytes(token.encode("utf-8"))
        if self._conn.recv_bytes() != b"OK":
            self._conn.close()
            raise ConnectionError("client auth handshake failed")
        if self._call({"op": "ping"}) != "pong":
            raise ConnectionError("client handshake failed")

    # -- transport ---------------------------------------------------------
    def _call(self, msg: dict):
        with self._lock:
            self._conn.send(msg)
            resp = self._conn.recv()
        if resp is None:
            raise ConnectionError("client connection closed by server")
        if not resp.get("ok"):
            raise cloudpickle.loads(resp["error"])
        return resp["result"]

    # -- WorkerContext surface --------------------------------------------
    @property
    def current_task_id(self) -> Optional[bytes]:
        return getattr(self._tls, "task_id", None)

    @property
    def current_actor_id(self) -> Optional[bytes]:
        return getattr(self._tls, "actor_id", None)

    def put_object(self, value, oid: Optional[bytes] = None) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("passing an ObjectRef to put is not allowed")
        oid_out = self._call({"op": "put", "oid": oid,
                              "blob": cloudpickle.dumps(value)})
        return ObjectRef(oid_out)

    def get_object(self, ref: ObjectRef, timeout: Optional[float] = None):
        blob = self._call({"op": "get", "oid": ref.binary(),
                           "timeout": timeout})
        return cloudpickle.loads(blob)

    def register_function(self, fn) -> bytes:
        cached = self._fn_cache.get(id(fn))
        if cached is not None and cached[0] is fn:
            return cached[1]
        fn_id = self._call({"op": "register_function",
                            "blob": cloudpickle.dumps(fn)})
        self._fn_cache[id(fn)] = (fn, fn_id)
        return fn_id

    def submit(self, spec) -> None:
        self._call({"op": "submit", "spec": spec})

    def rpc(self, method: str, params: dict):
        return self._call({"op": "rpc", "method": method, "params": params})

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        ready, pending = self._call({
            "op": "wait", "oids": [r.binary() for r in refs],
            "num_returns": num_returns, "timeout": timeout,
            "fetch_local": fetch_local})
        return ([ObjectRef(o) for o in ready],
                [ObjectRef(o) for o in pending])

    def close(self):
        self._conn.close()


def connect_client(address: str) -> ClientContext:
    """address: "rtpu://[token@]host:port" (token may also come from the
    RTPU_CLIENT_TOKEN env var)."""
    hostport = address[len("rtpu://"):]
    token = None
    if "@" in hostport:
        token, _, hostport = hostport.rpartition("@")
    host, _, port = hostport.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad client address {address!r}; expected "
                         f"rtpu://[token@]host:port")
    return ClientContext(host, int(port), token=token)
