"""Device objects: ObjectRefs whose payload stays resident on the producer.

Counterpart of ``ray_tpu/_private/device_objects.py`` (and of the
reference's GPU objects / Ray Direct Transport, Ray's
python/ray/_private/gpu_object_manager.py): an actor method called with
``.options(tensor_transport="device")`` keeps its return value in the
producing actor's process — a CUDA tensor stays in the card's memory — and
seals only a small marker into the object store.

Two planes, picked per get:

- **Same process** — when the consumer shares the producer's process (a
  ``max_concurrency`` actor's methods, or mesh members that one process
  drives), the get returns the resident tensor itself: same storage, same
  ``data_ptr``, and zero bytes through the shm store.  Given a placement
  (a partition-spec tuple over the active mesh context,
  ``parallel/mesh.py``), it takes the block that spec puts on this rank
  (``parallel/sharding.local_block``) on the context's device, where the
  JAX package reshards in one jitted program.
- **Host relay (fallback)** — any other consumer runs a hidden
  ``__rtpu_apply__`` task on the producer, which writes the tensor from
  the card into the shm store; the consumer gets a CPU tensor viewing the
  store (``_private/serialization.py``) and moves it where it wants it.

``free_device_object`` drops the producer's reference, so the CUDA caching
allocator can hand the memory to the next tensor.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

# host-relay pulls performed by this process (tests assert the
# same-process path leaves it untouched)
RELAY_PULLS = 0

# Producer-side residency table, per worker process: oid -> value.
_resident: Dict[bytes, Any] = {}
_lock = threading.Lock()


class DeviceObjectMarker:
    """The store payload for a device-resident object."""

    __slots__ = ("actor_id", "oid")

    def __init__(self, actor_id: bytes, oid: bytes):
        self.actor_id = actor_id
        self.oid = oid

    def __reduce__(self):
        return (DeviceObjectMarker, (self.actor_id, self.oid))

    def __repr__(self):
        return (f"DeviceObjectMarker(actor={self.actor_id.hex()[:8]}, "
                f"oid={self.oid.hex()[:8]})")


def store_resident(oid: bytes, value: Any) -> None:
    with _lock:
        _resident[oid] = value


def _fetch(_instance, oid: bytes):
    """Hidden task run ON the producer: hand the value to the store path."""
    with _lock:
        try:
            return _resident[oid]
        except KeyError:
            raise RuntimeError(
                f"device object {oid.hex()[:12]} is no longer resident "
                f"(freed or actor restarted)") from None


def _free(_instance, oid: bytes) -> bool:
    with _lock:
        return _resident.pop(oid, None) is not None


def free_resident_for_actor() -> None:
    """Clear the table (actor teardown)."""
    with _lock:
        _resident.clear()


_MISSING = object()  # a resident value may legitimately BE None


def _place(value, spec):
    """The block of ``value`` that the partition-spec tuple ``spec`` puts
    on this rank of the active mesh context, on the context's device: a
    replicated spec on the tensor's own device returns it as it is."""
    import torch

    from ray_tpu_torch.parallel import mesh as mesh_mod
    from ray_tpu_torch.parallel.sharding import local_block

    ctx = mesh_mod.active_mesh_context()
    if ctx is None:
        raise RuntimeError(
            "a placement needs an active mesh context "
            "(parallel.mesh.set_active_mesh_context)")
    dev_type = getattr(ctx.mesh, "device_type", "cpu")
    device = (torch.device(dev_type, torch.cuda.current_device())
              if dev_type == "cuda" else torch.device(dev_type))
    return local_block(value, tuple(spec), ctx.mesh).to(device)


def resolve_marker(marker: DeviceObjectMarker, timeout=None,
                   sharding=None):
    """Consumer side: resolve a device object.

    Same process (the value is resident here): return the resident tensor
    itself, or its block under ``sharding`` (a partition-spec tuple over
    the active mesh context).  Any other process: host relay via the
    producer actor, which returns a CPU tensor viewing the store."""
    from ray_tpu_torch import api
    from ray_tpu_torch.core.actor import ActorHandle

    with _lock:
        value = _resident.get(marker.oid, _MISSING)
    if value is not _MISSING:  # same process: no store bytes
        return _place(value, sharding) if sharding is not None else value
    handle = ActorHandle(marker.actor_id, "DeviceObjectOwner")
    ref = handle.__rtpu_apply__.remote(_fetch, marker.oid)
    value = api.get(ref, timeout=timeout)
    global RELAY_PULLS
    with _lock:
        RELAY_PULLS += 1  # successful host-relay pulls only
    if sharding is not None:
        value = _place(value, sharding)
    return value


def get_device_object(ref, sharding=None, timeout: Optional[float] = None):
    """Get a device object, placing the result under ``sharding``.

    ``sharding`` is a partition-spec tuple (``()`` replicates) resolved
    against the active mesh context: the result is this rank's block on
    the context's device.  A consumer in another process gets the tensor
    through the host relay first.
    """
    from ray_tpu_torch._private import worker as worker_mod

    ctx = worker_mod.global_worker()
    value = ctx.get_object_raw(ref, timeout=timeout)
    if isinstance(value, DeviceObjectMarker):
        return resolve_marker(value, timeout=timeout, sharding=sharding)
    if sharding is not None:
        return _place(value, sharding)
    return value


def free_device_object(ref) -> bool:
    """Release the producer-resident value for ``ref``: the producer drops
    its reference, and the caching allocator may reuse the memory."""
    from ray_tpu_torch import api
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.core.actor import ActorHandle

    ctx = worker_mod.global_worker()
    value = ctx.get_object_raw(ref)
    if not isinstance(value, DeviceObjectMarker):
        raise TypeError(f"{ref} is not a device object")
    handle = ActorHandle(value.actor_id, "DeviceObjectOwner")
    return api.get(handle.__rtpu_apply__.remote(_free, value.oid))
