"""User-facing exceptions (counterpart of Ray's python/ray/exceptions.py)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for framework errors."""


class TaskError(RayTpuError):
    """A remote task raised; re-raised at ``get`` with the remote traceback."""

    def __init__(self, cause: BaseException, remote_traceback: str = ""):
        self.cause = cause
        self.remote_traceback = remote_traceback
        super().__init__(
            f"{type(cause).__name__}: {cause}\n"
            f"--- remote traceback ---\n{remote_traceback}"
        )


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died unexpectedly."""


class OutOfMemoryError(WorkerCrashedError):
    """The worker was killed by the node memory monitor (reference:
    ray.exceptions.OutOfMemoryError raised by the raylet's worker-killing
    policy under memory pressure).  The message carries provenance: the
    worker's RSS at kill time and the node usage that tripped the
    threshold."""


class ActorDiedError(RayTpuError):
    """The actor owning this method call has died."""


class ActorUnavailableError(RayTpuError):
    """The actor exists but cannot currently serve calls."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` exceeded its timeout."""


class StoreDiedError(RayTpuError):
    """The local shm store daemon stayed unreachable past the reconnect
    budget (``RTPU_STORE_RETRY_S``).

    ``StoreClient`` transparently redials through daemon restarts (the
    node supervisor respawns a crashed daemon on the same socket within
    a second), so this only surfaces when supervision itself is gone —
    an in-flight task failing with it is retried like any worker crash,
    and lost objects recover via lineage.
    """


class ObjectLostError(RayTpuError):
    """Object is no longer available (lost with its node, or evicted).

    ``oid`` (when known) identifies the lost object so an owner holding
    its lineage can re-execute the producing task (reference:
    src/ray/core_worker/object_recovery_manager.h:43).
    """

    def __init__(self, *args, oid: bytes = b""):
        super().__init__(*args)
        self.oid = oid

    def __reduce__(self):
        if type(self) is not ObjectLostError:
            # dynamic TaskError duals (serialization._as_raisable) subclass
            # this — they must keep their own pickling, not collapse to a
            # bare ObjectLostError
            return super().__reduce__()
        return (_rebuild_object_lost, (self.args, self.oid))


def _rebuild_object_lost(args, oid):
    return ObjectLostError(*args, oid=oid)


class TaskCancelledError(RayTpuError):
    """The task was cancelled before/while running."""


class RuntimeEnvSetupError(RayTpuError):
    """Runtime environment could not be set up for the task/actor."""


class PlacementGroupUnavailableError(RayTpuError):
    """Placement group resources could not be reserved."""
