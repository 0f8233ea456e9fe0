"""Binary IDs for tasks/actors/objects.

Mirrors the reference's ID hierarchy (see
Ray's src/ray/design_docs/id_specification.md: JobID ⊂ ActorID ⊂
TaskID ⊂ ObjectID, where an ObjectID is a TaskID plus a return index) in a
simplified 20-byte flat form: ObjectIDs produced by a task share the task's
16-byte prefix with a 4-byte little-endian return index suffix.
"""

from __future__ import annotations

import itertools
import os
import struct

OBJECT_ID_LEN = 20
TASK_ID_LEN = 16
ACTOR_ID_LEN = 16
NIL_ID = b"\x00" * OBJECT_ID_LEN

# Process-unique 8-byte prefix + monotonic counter: the reference builds
# ids the same way (owner id + task counter, id_specification.md) rather
# than drawing entropy per id — os.urandom costs ~15us per call on small
# hosts, which is most of a task submission.  The prefix is drawn once per
# process; os.register_at_fork re-draws it in children so forked workers
# never collide.
_prefix = os.urandom(8)
_counter = itertools.count(int.from_bytes(os.urandom(4), "little"))


def _refresh_prefix():
    global _prefix
    _prefix = os.urandom(8)


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_refresh_prefix)


def _unique(n_suffix: int) -> bytes:
    return _prefix + next(_counter).to_bytes(n_suffix, "little",
                                             signed=False)


def new_task_id() -> bytes:
    return _unique(TASK_ID_LEN - 8)


def new_actor_id() -> bytes:
    return _unique(ACTOR_ID_LEN - 8)


def object_id_for_return(task_id: bytes, index: int) -> bytes:
    return task_id + struct.pack("<I", index)


def random_object_id() -> bytes:
    """For driver ``put``s, which have no producing task."""
    return _unique(OBJECT_ID_LEN - 8)


def hex_short(id_bytes: bytes) -> str:
    return id_bytes[:6].hex()
