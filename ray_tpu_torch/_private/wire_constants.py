"""Single source of truth for every cross-language wire constant.

Each C++ daemon under ``ray_tpu/native/`` speaks a hand-rolled framed
protocol to a Python peer.  The numeric constants that define those
protocols — opcodes, status codes, frame-header layouts, version bytes —
used to be declared twice: once in the ``.cc`` file and once in the
Python client that speaks to it (and occasionally a third time in a
second Python module).  This module is the one Python-side declaration;
the clients import from here, and the static drift pass
(``ray_tpu/_private/staticcheck/drift.py``) compares these values
against the constants it extracts from the C++ sources, so a change on
either side that is not mirrored fails ``rtpu check``.

Kept stdlib-only and import-light on purpose: ``rtpu check`` runs with
no accelerator runtime and no cluster.

C++ peers, by protocol group:

- store plane  -> native/shm_store.cc   (OP_*/ST_*/kIdLen/kReqLen/kRespLen)
- xfer plane   -> native/shm_store.cc   (XFER_* daemon-to-daemon listener)
- control codec-> native/wire.h         (kVersion/kHello/kMaxDepth/kMaxItems)
- frame cap    -> native/core_worker.cc + native/gcs_server.cc (kMaxFrame)
- direct plane -> native/core_worker.cc (0x01 call / 0x02 reply frames)
- channels     -> native/mutable_channel.cc (kMagic header word)
"""

from __future__ import annotations

import struct

# --- control-plane value codec (wire.py <-> native/wire.h) -----------------
WIRE_VERSION = 1
HELLO = b"RTPUWIRE" + bytes([WIRE_VERSION])
HELLO_OK = b"RTPUWIRE-OK" + bytes([WIRE_VERSION])
MAX_DEPTH = 32
MAX_ITEMS = 1 << 22  # 4M elements in one collection

# --- framed control plane (protocol.py <-> core_worker.cc/gcs_server.cc) ---
# One frame = <u32 length | payload>; both C++ daemons cap inbound frames
# at kMaxFrame and Python's Connection.recv_frame defaults to the same cap.
MAX_FRAME = 1 << 28

# --- shared-memory store plane (store_client.py <-> shm_store.cc) ----------
OBJECT_ID_LEN = 20
# Request: u8 op | u8[20] object_id | u64 arg0 | u64 arg1  (37 bytes)
# Response: u8 status | u64 | u64                          (17 bytes)
STORE_REQ = struct.Struct("<B20sQQ")
STORE_RESP = struct.Struct("<BQQ")

ST_OK = 0
ST_NOT_FOUND = 1
ST_EXISTS = 2
ST_OOM = 3
ST_TIMEOUT = 4
ST_NOT_SEALED = 5
ST_ERR = 6
ST_EVICTED = 7
ST_VIEW = 8  # GET_INLINE: too big to inline; pin kept, (offset, size) back

OP_CREATE = 1
OP_SEAL = 2
OP_GET = 3
OP_RELEASE = 4
OP_DELETE = 5
OP_CONTAINS = 6
OP_STATS = 7
OP_ABORT = 8
OP_PUT = 9
OP_GET_INLINE = 10
OP_PULL = 11
OP_PUSH = 12
OP_AUDIT = 13

# Daemon-to-daemon transfer listener (no Python speaker today; the store
# daemon proxies via OP_PULL/OP_PUSH).  Anchored here so the C++ side
# can't renumber silently.
XFER_PULL = 1
XFER_PUSH = 2
XFER_PULL_RANGE = 3

# --- direct-call transport (direct.py <-> core_worker.cc) ------------------
FRAME_CALL = 0x01
FRAME_REPLY = 0x02
FRAME_CALL_PICKLED = 0x03

# --- mutable channels (dag/native_channel.py <-> mutable_channel.cc) -------
CHANNEL_MAGIC = 0x52545055434841  # "RTPUCHA"
