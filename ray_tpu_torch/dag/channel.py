"""Shared-memory channels: the compiled-DAG data plane.

Counterpart of the reference's mutable-object channels
(Ray's src/ray/core_worker/experimental_mutable_object_manager.h:44,
python/ray/experimental/channel/shared_memory_channel.py). The reference
implements a writer/reader semaphore protocol over one mutable plasma buffer;
here a channel is a bounded ring of *immutable* store objects — write ``seq``
seals object ``h(chan_id, seq)``, read ``seq`` gets (and frees) it — which
keeps the store's single immutability invariant and still moves arrays
zero-copy through shm. Backpressure: the reader acks its read sequence into
the GCS KV; the writer blocks once it is ``capacity`` messages ahead (the
KV round-trip is only paid when the ring is actually full). Cross-node reads
ride the normal object-transfer pull path, so a channel between actors on
different hosts needs no extra machinery.

Torch tensors, on the CPU or on CUDA and of any dtype, travel as the
store writes them (``_private/serialization.py``: a CUDA tensor is copied
from the card into the slot or the ring) and arrive as CPU tensors, which
the reader moves onto its card itself.  A reader owns what it gets: a
tensor read off the store transport is cloned before the ack, as a numpy
array is copied.  ``writes`` counts this process's writes by the path they
took (``"ring"``, ``"spilled"``: a native-ring message spilled through
the store, ``"store"``); teardown's stop marker is not a message and is
not counted.
"""

from __future__ import annotations

import hashlib
import sys
import time
from typing import Optional

import numpy as np

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.core.object_ref import ObjectRef

_KV_NS = "dag_channel"
_POLL_S = 0.001

writes = {"ring": 0, "spilled": 0, "store": 0}


class ChannelClosed(Exception):
    pass


class _Stop:
    """Sentinel flowing through channels on teardown."""

    def __repr__(self):
        return "<dag stop>"


STOP = _Stop()


class _Spill:
    """Marker streamed through a native ring when the payload was too large
    and spilled through the object store. A dedicated class (not a dict key)
    so no user payload can ever be mistaken for it."""

    __slots__ = ("oid",)

    def __init__(self, oid: bytes):
        self.oid = oid

    def __repr__(self):
        return f"<dag spill {self.oid.hex()[:8]}>"


def _is_tensor(value) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(value, torch.Tensor)


def _ctx():
    w = worker_mod.global_worker()
    if w is None:
        raise RuntimeError("ray_tpu_torch not initialized in this process")
    return w


class Channel:
    """One writer, one reader, bounded capacity. Pickles to the same channel
    (id + capacity travel; seq state is per-process endpoint state).

    Two transports, chosen at compile time per edge:
    - ``native=True`` (both endpoints on one node): the C++ mutable shm
      ring (native/mutable_channel.cc) — kernel-blocking, one memcpy per
      side, no store or KV traffic. Messages larger than the ring spill
      through the object store transparently.
    - ``native=False`` (cross-node): immutable store objects + KV-acked
      ring backpressure; reads ride the normal object-transfer pull path.
    """

    def __init__(self, chan_id: bytes, capacity: int = 16,
                 native: bool = False):
        self.chan_id = chan_id
        self.capacity = capacity
        self.native = native
        self._wseq = 0
        self._rseq = 0
        self._acked = -1
        self._spills = 0
        self._native_chan = None

    def __reduce__(self):
        return (Channel, (self.chan_id, self.capacity, self.native))

    def _native(self):
        if self._native_chan is None:
            from ray_tpu_torch.dag.native_channel import NativeChannel

            self._native_chan = NativeChannel(
                f"/rtpu_chan_{self.chan_id.hex()}")
        return self._native_chan

    def unlink_native(self) -> None:
        """Reclaim this channel's shm segment on THIS host (no-op for
        store-transport channels or if never created here)."""
        if not self.native:
            return
        try:
            from ray_tpu_torch.dag.native_channel import _load

            _load().mc_unlink(f"/rtpu_chan_{self.chan_id.hex()}".encode())
        except Exception:
            pass

    def _oid(self, seq: int) -> bytes:
        return hashlib.sha1(
            self.chan_id + seq.to_bytes(8, "little")).digest()[:20]

    def _spill_oid(self) -> bytes:
        self._spills += 1
        return hashlib.sha1(b"spill" + self.chan_id + self._spills.to_bytes(
            8, "little")).digest()[:20]

    def _ack_key(self) -> bytes:
        return b"ack/" + self.chan_id

    # -- writer end --------------------------------------------------------
    def write(self, value, timeout: Optional[float] = None) -> None:
        ctx = _ctx()
        if self.native:
            try:
                self._native().write(value, timeout=timeout)
            except ValueError:
                # larger than the ring: spill payload through the store,
                # stream a small marker so ordering is preserved.  The
                # object gets a channel-derived id: a random-id put is owned
                # by this process and freed as soon as its ref drops, before
                # the reader could get it (the JAX package's channel puts
                # it so, and its reader finds nothing).  The reader deletes it.
                oid = self._spill_oid()
                ctx.put_object(value, oid=oid)
                self._native().write(_Spill(oid), timeout=timeout)
                writes["spilled"] += 1
            else:
                writes["ring"] += not isinstance(value, _Stop)
            return
        if self._wseq - self._acked > self.capacity:
            deadline = None if timeout is None else time.monotonic() + timeout
            while True:
                raw = ctx.rpc("kv_get", {"namespace": _KV_NS,
                                         "key": self._ack_key()})
                if raw is not None:
                    ack = int.from_bytes(raw, "little", signed=True)
                    if ack > self._acked:
                        # reader consumed up to ack: reclaim our local copies
                        for s in range(max(0, self._acked), ack + 1):
                            try:
                                ctx.store.delete(self._oid(s))
                            except Exception:
                                pass
                        self._acked = ack
                if self._wseq - self._acked <= self.capacity:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"channel {self.chan_id.hex()[:8]} write timed out "
                        f"(reader {self._wseq - self._acked} behind)")
                time.sleep(_POLL_S)
        ctx.put_object(value, oid=self._oid(self._wseq))
        self._wseq += 1
        writes["store"] += not isinstance(value, _Stop)

    # -- reader end --------------------------------------------------------
    def read(self, timeout: Optional[float] = None):
        ctx = _ctx()
        if self.native:
            value = self._native().read(timeout=timeout)
            if isinstance(value, _Spill):
                oid = value.oid
                value = ctx.get_object(ObjectRef(oid), timeout=timeout)
                try:
                    ctx.store.delete(oid)
                except Exception:
                    pass
            if isinstance(value, _Stop):
                raise ChannelClosed()
            return value
        value = ctx.get_object(ObjectRef(self._oid(self._rseq)),
                               timeout=timeout)
        if isinstance(value, np.ndarray):
            # Own the data before the backing shm buffer can be reclaimed by
            # the writer once we ack.
            value = np.array(value)
        elif _is_tensor(value):
            value = value.clone()
        try:
            ctx.store.delete(self._oid(self._rseq))
        except Exception:
            pass
        ctx.rpc("kv_put", {
            "namespace": _KV_NS, "key": self._ack_key(),
            "value": self._rseq.to_bytes(8, "little", signed=True)})
        self._rseq += 1
        if isinstance(value, _Stop):
            raise ChannelClosed()
        return value
