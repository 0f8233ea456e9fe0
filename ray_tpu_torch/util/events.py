"""Structured serving events: preemptions, resumes, KV tier pulls and
fallbacks.

Counterpart of the event plane of ``ray_tpu/util/events.py``.  ``emit()``
records one structured incident, stamped with the current trace id when
one is attached so it links into the request's trace tree, into a
process-local ring of the last 512 records; ``take_buffered()`` drains the
ring.  The JAX package's flusher, which pushes the ring to its node
scheduler, and its file exporter stay there: the port has no runtime to
push to.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ray_tpu_torch.util import tracing

_EV_BUF_MAX = 512  # process-local backlog; oldest dropped past this
_ev_lock = threading.Lock()
_ev_buf: list[dict] = []
_ev_recent: dict[str, list] = {}  # kind -> [ts, record] for coalescing


def emit(kind: str, message: str = "", severity: str = "info",
         data: Optional[dict] = None, trace_id: Optional[str] = None,
         coalesce_s: float = 0.0) -> dict:
    """Record one structured event and return it.

    coalesce_s > 0 merges a repeat of the same kind arriving within the
    window into the buffered record's ``count`` instead of appending, so
    hot emitters do not flood the ring.  Every record waits in the ring
    for ``take_buffered()``."""
    now = time.time()
    if trace_id is None:
        ctx = tracing.current_context()
        trace_id = ctx[0] if ctx else ""
    rec = {"ts": now, "kind": str(kind), "severity": str(severity),
           "message": str(message), "data": dict(data or {}),
           "pid": os.getpid(), "trace_id": trace_id or ""}
    with _ev_lock:
        if coalesce_s > 0:
            recent = _ev_recent.get(rec["kind"])
            if (recent is not None and now - recent[0] < coalesce_s
                    and recent[1].get("_buffered")):
                merged = recent[1]
                merged["data"]["count"] = merged["data"].get("count", 1) + 1
                merged["ts"] = now
                return merged
            _ev_recent[rec["kind"]] = [now, rec]
        rec["_buffered"] = True
        _ev_buf.append(rec)
        if len(_ev_buf) > _EV_BUF_MAX:
            dropped = _ev_buf[:len(_ev_buf) - _EV_BUF_MAX]
            del _ev_buf[:len(_ev_buf) - _EV_BUF_MAX]
            for r in dropped:
                r.pop("_buffered", None)
    return rec


def take_buffered() -> list[dict]:
    """Drain the process-local ring, oldest first."""
    with _ev_lock:
        batch = list(_ev_buf)
        del _ev_buf[:]
        for r in batch:
            r.pop("_buffered", None)
    return batch
