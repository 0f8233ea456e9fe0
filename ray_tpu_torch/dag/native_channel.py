"""ctypes binding for the native mutable shm channel.

See ray_tpu_torch/native/mutable_channel.cc (counterpart of the reference's
mutable-object channels). One writer, one reader, same host. Payloads are
the same serialization the object store uses (tagged pickle/array/tensor
bytes), so arrays and tensors ride through with a single memcpy each side.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

from ray_tpu_torch._private.serialization import deserialize, serialized_size, write_payload
# The C side stamps CHANNEL_MAGIC ("RTPUCHA") into the segment header
# last, so mc_open rejects half-initialized segments; the drift pass
# (`rtpu check`) pins mutable_channel.cc's kMagic to this anchor.
from ray_tpu_torch._private.wire_constants import CHANNEL_MAGIC


class NativeChannelClosed(Exception):
    pass


_lib = None


def _load():
    global _lib
    if _lib is None:
        from ray_tpu_torch.native.build import binary_path

        lib = ctypes.CDLL(binary_path("libmutable_channel"))
        lib.mc_create.restype = ctypes.c_void_p
        lib.mc_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.mc_open.restype = ctypes.c_void_p
        lib.mc_open.argtypes = [ctypes.c_char_p]
        lib.mc_write.restype = ctypes.c_int
        lib.mc_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_uint64, ctypes.c_int]
        lib.mc_read.restype = ctypes.c_int64
        lib.mc_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_uint64, ctypes.c_int]
        lib.mc_next_len.restype = ctypes.c_int64
        lib.mc_next_len.argtypes = [ctypes.c_void_p]
        lib.mc_close_channel.argtypes = [ctypes.c_void_p]
        lib.mc_release.argtypes = [ctypes.c_void_p]
        lib.mc_unlink.restype = ctypes.c_int
        lib.mc_unlink.argtypes = [ctypes.c_char_p]
        _lib = lib
    return _lib


class NativeChannel:
    """Open (creating if first) a named mutable channel."""

    def __init__(self, name: str, capacity: int = 1 << 22):
        self._name = name.encode()
        self._lib = _load()
        handle = self._lib.mc_create(self._name, capacity)
        if not handle:
            # creator may still be mid-init (magic not yet set): brief retry
            import time as _time

            for _ in range(200):
                handle = self._lib.mc_open(self._name)
                if handle:
                    break
                _time.sleep(0.005)
        if not handle:
            raise OSError(
                f"could not create/open native channel {name} (header "
                f"magic {CHANNEL_MAGIC:#x} never appeared: creator died "
                "mid-init or the segment is foreign)")
        self._handle = handle
        self._capacity = capacity
        self._buf = ctypes.create_string_buffer(1 << 16)

    _CHUNK_MS = 60_000  # timeout=None waits forever in bounded C-side slices

    def write(self, value, timeout: Optional[float] = None) -> None:
        size, token = serialized_size(value)
        if size + 4 > self._capacity:
            # refused before the payload is assembled: a CUDA tensor's bytes
            # would otherwise leave the card once for nothing (the C side
            # checks the same frame size against the segment's own header)
            raise ValueError(f"message of {size} bytes exceeds channel "
                             f"capacity")
        payload = bytearray(size)
        write_payload(memoryview(payload), token)
        # zero-copy hand-off: C memcpys straight out of the bytearray
        buf = (ctypes.c_char * size).from_buffer(payload)
        ms = None if timeout is None else int(timeout * 1000)
        while True:
            rc = self._lib.mc_write(
                self._handle, buf, size,
                self._CHUNK_MS if ms is None else ms)
            if rc == -1 and ms is None:
                continue  # infinite wait: keep blocking in bounded slices
            break
        if rc == -1:
            raise TimeoutError("native channel write timed out")
        if rc == -2:
            raise NativeChannelClosed()
        if rc == -3:
            raise ValueError(f"message of {size} bytes exceeds channel "
                             f"capacity")

    def read(self, timeout: Optional[float] = None):
        ms = None if timeout is None else int(timeout * 1000)
        while True:
            n = self._lib.mc_read(
                self._handle, self._buf, len(self._buf),
                self._CHUNK_MS if ms is None else ms)
            if n == -4:
                need = self._lib.mc_next_len(self._handle)
                if need > 0:
                    self._buf = ctypes.create_string_buffer(int(need))
                    continue
                continue
            if n == -1 and ms is None:
                continue  # infinite wait: keep blocking in bounded slices
            break
        if n == -1:
            raise TimeoutError("native channel read timed out")
        if n == -2:
            raise NativeChannelClosed()
        # own the bytes before the ring buffer slot is reused: arrays
        # deserialize zero-copy over this immutable copy
        payload = self._buf.raw[: int(n)]
        return deserialize(memoryview(payload))

    def close(self) -> None:
        self._lib.mc_close_channel(self._handle)

    def release(self) -> None:
        if self._handle:
            self._lib.mc_release(self._handle)
            self._handle = None

    def unlink(self) -> None:
        self._lib.mc_unlink(self._name)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass
