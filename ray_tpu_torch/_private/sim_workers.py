"""Simulated worker fleet for control-plane scale benchmarks.

Counterpart of ``ray_tpu/_private/sim_workers.py``, that is, of Ray's
release-test mock workers (release/benchmarks/distributed/: the many_*
tests measure the control plane, meaning GCS tables, raylet dispatch and
worker lease, not user code): each "worker" here is one node-service
connection that registers a worker id and acknowledges task assignments
at once, without a subprocess, an interpreter or a store write.  One
selector thread multiplexes the whole fleet, so a small host can register
1,000+ workers and drive tens of thousands of dispatch cycles per second
against the port's real scheduler, native raylet and GCS.  It speaks the
scheduler's protocol: length-prefixed frames, the native raylet's
``0x11`` ASSIGN / ``0x12`` DONE, and pickled (``0x80``) messages.

Gated on the scheduler's side by ``RTPU_ALLOW_SIM_WORKERS=1`` (its
register handler), never active in normal clusters.
"""

from __future__ import annotations

import os
import pickle
import selectors
import socket
import struct
import threading

_LEN = struct.Struct("<I")


class SimWorkerFleet:
    def __init__(self, scheduler_socket: str, n: int):
        self.scheduler_socket = scheduler_socket
        self.n = n
        self.worker_ids: list[bytes] = []
        self._sel = selectors.DefaultSelector()
        self._socks: list[socket.socket] = []
        self._bufs: dict[int, bytearray] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.assigned = 0  # tasks acknowledged (all dialects)

    # -- wire helpers ----------------------------------------------------
    @staticmethod
    def _frame(body: bytes) -> bytes:
        return _LEN.pack(len(body)) + body

    def _send_msg(self, sock: socket.socket, msg: dict):
        sock.sendall(self._frame(pickle.dumps(msg, protocol=5)))

    # -- lifecycle -------------------------------------------------------
    def start(self):
        for _ in range(self.n):
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.connect(self.scheduler_socket)
            worker_id = os.urandom(8)
            self.worker_ids.append(worker_id)
            self._send_msg(sock, {"t": "register",
                                  "worker_id": worker_id.hex(),
                                  "server_addr": None})
            # sockets stay BLOCKING: select gates recv (only fired when
            # readable, and recv returns the available bytes), and
            # sendall of small acks must not short-write
            self._sel.register(sock, selectors.EVENT_READ)
            self._bufs[sock.fileno()] = bytearray()
            self._socks.append(sock)
        self._thread = threading.Thread(target=self._loop, name="sim-fleet",
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for sock in self._socks:
            try:
                sock.close()
            except OSError:
                pass

    # -- the fleet loop --------------------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            for key, _ in self._sel.select(timeout=0.2):
                sock = key.fileobj
                try:
                    data = sock.recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    self._drop(sock)
                    continue
                if not data:
                    self._drop(sock)
                    continue
                buf = self._bufs[sock.fileno()]
                buf += data
                self._drain(sock, buf)

    def _drop(self, sock):
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        self._bufs.pop(sock.fileno(), None)
        try:
            sock.close()
        except OSError:
            pass

    def _drain(self, sock, buf: bytearray):
        while len(buf) >= 4:
            (length,) = _LEN.unpack_from(buf)
            if len(buf) < 4 + length:
                return
            frame = bytes(buf[4:4 + length])
            del buf[:4 + length]
            self._handle(sock, frame)

    def _handle(self, sock, frame: bytes):
        if not frame:
            return
        try:
            if frame[0] == 0x11:
                # native raylet ASSIGN: ack with 0x12 DONE ok (the task
                # "executes" in zero time; no store write — control plane
                # only)
                tl = frame[1]
                tid = frame[2:2 + tl]
                sock.sendall(self._frame(
                    bytes([0x12, len(tid)]) + tid + b"\x01"))
                self.assigned += 1
            elif frame[0] == 0x80:
                msg = pickle.loads(frame)
                if msg.get("t") == "task":
                    spec = msg["spec"]
                    self._send_msg(sock, {"t": "done",
                                          "task_id": spec.task_id,
                                          "ok": True, "error": None})
                    self.assigned += 1
                elif msg.get("t") == "shutdown":
                    self._drop(sock)
        except OSError:
            self._drop(sock)
