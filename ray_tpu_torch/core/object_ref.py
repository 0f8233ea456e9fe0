"""ObjectRef: a handle to an object in the distributed store.

Counterpart of the reference's ObjectRef
(Ray's python/ray/includes/object_ref.pxi): a 20-byte ID whose
payload lives in the shared-memory store (or will, once its producing task
finishes).  Pickling an ObjectRef transfers the ID only; the receiving process
resolves it against its own store client.
"""

from __future__ import annotations

# Called with the oid whenever a ref is pickled (it may leave this
# process): the worker context promotes memory-store-only values to the
# shm store so any receiver can resolve the ref.  A module-level hook
# (not a WorkerContext import) keeps this file dependency-free.
_escape_hook = None
# Local ref lifecycle (reference: ReferenceCounter local refs,
# Ray's src/ray/core_worker/reference_count.h:73): the worker
# context counts live ObjectRef instances per oid so in-process memory
# store entries can be released when the last local ref is dropped.
_on_ref_created = None
_on_ref_deleted = None


def set_escape_hook(hook) -> None:
    global _escape_hook
    _escape_hook = hook


def set_lifecycle_hooks(on_created, on_deleted) -> None:
    global _on_ref_created, _on_ref_deleted
    _on_ref_created = on_created
    _on_ref_deleted = on_deleted


class ObjectRef:
    __slots__ = ("_id",)

    def __init__(self, id_bytes: bytes):
        self._id = id_bytes
        if _on_ref_created is not None:
            _on_ref_created(id_bytes)

    def __del__(self):
        if _on_ref_deleted is not None:
            try:
                _on_ref_deleted(self._id)
            except Exception:
                pass  # interpreter shutdown: hooks may be half-torn-down

    def binary(self) -> bytes:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def __reduce__(self):
        if _escape_hook is not None:
            _escape_hook(self._id)
        return (ObjectRef, (self._id,))

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()[:16]})"
