"""Structured event export for external consumers.

Counterpart of the reference's export-event pipeline
(Ray's python/ray/_private/event/export_event_logger.py + the
export_*.proto schemas): when enabled, cluster lifecycle events stream to
JSONL files an external system can tail — one record per line, stable
``type``/``ts``/``data`` envelope.

Enable by pointing ``RTPU_EXPORT_EVENTS`` at a directory (the head node
starts the exporter).  Four files are written there:

- ``actor_events.jsonl``   — every actor state transition (from GCS pubsub)
- ``node_events.jsonl``    — node alive/dead transitions
- ``task_events.jsonl``    — task lifecycle records (exported by each
  node's scheduler as tasks finish)
- ``cluster_events.jsonl`` — the cluster event plane (below): the file
  exporter is ONE SUBSCRIBER of that plane (the scheduler forwards every
  banked event here), not a parallel path

Cluster event plane
-------------------
``emit()`` records a structured in-cluster incident — store-daemon
restarts, replica deaths, KV tier pulls/fallbacks, spill decisions,
preemptions, data-worker scale actions, every ``RTPU_TESTING_*`` chaos
injection — stamped with the current trace id when one is attached, so
incidents link into the trace tree.  Records buffer process-locally and a
background flusher pushes them to the node scheduler over the control
socket ("events_push", the incident lane next to metrics_push/spans_push/
goodput_push); the scheduler banks them in a capped ring
(``RTPU_EVENTS_CAP``) that ``rtpu events`` / ``state.list_events`` /
``/api/events`` read and the head's sampler drains.  Severity "error"/
"critical" (and ``flush=True`` — chaos sites that ``os._exit``) push
synchronously so the incident survives the process it describes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class ExportEventLogger:
    """Exporter for one node.  Every node exports its scheduler's task
    events (enqueued, written by a dedicated thread — the sink is called
    under the scheduler's lock and must not do file I/O there); the HEAD
    additionally subscribes to the GCS actor/node channels so those
    cluster-wide transitions are written exactly once."""

    def __init__(self, out_dir: str, gcs_address: str,
                 subscribe: bool = True):
        import queue as queue_mod

        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._gcs_address = gcs_address
        self._stop = threading.Event()
        self._files: dict[str, object] = {}
        self._lock = threading.Lock()
        self._queue: "queue_mod.Queue" = queue_mod.Queue()
        self._writer = threading.Thread(
            target=self._writer_loop, name="event-export-writer",
            daemon=True)
        self._writer.start()
        self._sub_thread = None
        if subscribe:
            self._sub_thread = threading.Thread(
                target=self._subscribe_loop, name="event-export-sub",
                daemon=True)
            self._sub_thread.start()

    def _write(self, stream: str, record: dict):
        """Serialize + append one record (writer/subscriber threads only).
        Unbuffered O_APPEND binary writes: one write(2) per line of ANY
        size, so concurrent exporters appending to the same file
        (multi-node, shared fs) stay line-atomic — a buffered text file
        would split records beyond its buffer into interleavable chunks."""
        line = json.dumps({"type": stream, "ts": time.time(),
                           "data": record}, default=_jsonable)
        with self._lock:
            f = self._files.get(stream)
            if f is None:
                f = open(os.path.join(self.out_dir,
                                      f"{stream}_events.jsonl"), "ab",
                         buffering=0)
                self._files[stream] = f
            f.write((line + "\n").encode())

    def export_task_event(self, record: dict):
        """Called by the scheduler (under its lock): enqueue only."""
        self._queue.put(("task", record))

    def export_cluster_event(self, record: dict):
        """Cluster-event-plane subscription (scheduler bank_events):
        enqueue only — the bank is called from RPC reader threads."""
        self._queue.put(("cluster", record))

    def _writer_loop(self):
        import queue as queue_mod

        while True:
            try:
                stream, record = self._queue.get(timeout=0.5)
            except queue_mod.Empty:
                if self._stop.is_set():
                    return  # queue fully drained
                continue
            try:
                self._write(stream, record)
            except Exception:
                pass  # export is best-effort

    def _subscribe_loop(self):
        from ray_tpu_torch._private.gcs import GcsClient, GcsSubscriber

        sub = None
        while not self._stop.is_set():
            try:
                if sub is None:
                    sub = GcsSubscriber(self._gcs_address,
                                        ["actors", "nodes"])
                events, gap = sub.poll(timeout_s=5.0)
            except Exception:
                sub = None
                if self._stop.wait(0.5):
                    return
                continue
            # write what we HAVE before any snapshot re-read can fail —
            # a dropped DEAD transition is exactly what consumers need
            # most during GCS blips
            for e in events:
                ch = e.get("ch")
                if ch == "actors":
                    self._write("actor", e)
                elif ch == "nodes":
                    self._write("node", e)
            if gap:
                # subscriber contract: a gap (including the bootstrap
                # poll) means re-read table state — transitions published
                # before we subscribed surface as snapshot records
                try:
                    client = GcsClient(self._gcs_address)
                    for n in client.list_nodes():
                        self._write("node", {
                            "ch": "nodes", "node_id": n.node_id,
                            "alive": n.alive, "snapshot": True})
                    for a in client.list_actors():
                        self._write("actor", {
                            "ch": "actors", "actor_id": a.actor_id,
                            "state": a.state, "addr": a.addr,
                            "snapshot": True})
                except Exception:
                    pass  # next gap retries the snapshot

    def shutdown(self):
        """Stop, DRAINING queued task events first — short-lived drivers
        must not lose their final FINISHED records."""
        self._stop.set()
        self._writer.join(timeout=5)
        with self._lock:
            for f in self._files.values():
                try:
                    f.close()
                except OSError:
                    pass
            self._files.clear()
        global _exporter
        if _exporter is self:
            _exporter = None


def _jsonable(obj):
    if isinstance(obj, bytes):
        return obj.hex()
    return str(obj)


_exporter: Optional[ExportEventLogger] = None


def start_exporter(gcs_address: str,
                   subscribe: bool = True) -> Optional[ExportEventLogger]:
    """Start this node's exporter when RTPU_EXPORT_EVENTS names a
    directory.  subscribe=True (the head) additionally streams GCS
    actor/node transitions; other nodes export only their own task
    events."""
    global _exporter
    out_dir = os.environ.get("RTPU_EXPORT_EVENTS")
    if not out_dir:
        return None
    logger = ExportEventLogger(out_dir, gcs_address, subscribe=subscribe)
    # The process-global fallback serves schedulers that predate per-node
    # wiring; the FIRST exporter (the head's, in in-process multi-node
    # clusters) keeps it — a later worker Node must not hijack the head's
    # task events, nor leave a dead exporter behind on its shutdown.
    if _exporter is None:
        _exporter = logger
    return logger


def get_exporter() -> Optional[ExportEventLogger]:
    return _exporter


# -- cluster event plane (events_push lane) ------------------------------

_EV_BUF_MAX = 512  # process-local backlog; oldest dropped past this
_ev_lock = threading.Lock()
_ev_buf: list[dict] = []
_ev_recent: dict[str, list] = {}  # kind -> [ts, record] for coalescing
_ev_flusher_started = False
_ev_flush_stop = threading.Event()
_ev_tls = threading.local()


def emit(kind: str, message: str = "", severity: str = "info",
         data: Optional[dict] = None, trace_id: Optional[str] = None,
         flush: bool = False, coalesce_s: float = 0.0) -> dict:
    """Record one structured cluster event (see module docstring).

    coalesce_s > 0 merges a repeat of the same kind arriving within the
    window into the buffered record's ``count`` instead of appending —
    hot emitters (spills, preemptions, chaos frame drops) must not flood
    the ring or the control socket.  flush=True (and severity error/
    critical) pushes synchronously; everything else rides the background
    flusher.  Best-effort by design: with no driver/worker context the
    record waits in the process buffer until the node scheduler drains it
    (list_events / sample tick) or the process dies.
    """
    now = time.time()
    if trace_id is None:
        try:
            from ray_tpu_torch.util import tracing

            ctx = tracing.current_context()
            trace_id = ctx[0] if ctx else ""
        except Exception:
            trace_id = ""
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
    _ensure_ev_flusher()
    if flush or severity in ("error", "critical"):
        flush_events()
    return rec


def flush_events() -> None:
    """Push buffered events to the node scheduler now (best-effort; no-op
    without a driver/worker context).  Reentrancy-guarded: the push itself
    may traverse chaos-instrumented transport code that emits."""
    if getattr(_ev_tls, "flushing", False):
        return
    from ray_tpu_torch._private import worker as worker_mod

    ctx = worker_mod.global_worker_or_none()
    if ctx is None:
        return
    with _ev_lock:
        if not _ev_buf:
            return
        batch = list(_ev_buf)
        del _ev_buf[:]
        for r in batch:
            r.pop("_buffered", None)
    _ev_tls.flushing = True
    try:
        ctx.rpc("events_push", {"events": batch})
    except Exception:
        pass  # node shutting down; events are best-effort
    finally:
        _ev_tls.flushing = False


def take_buffered() -> list[dict]:
    """Drain the process-local buffer for direct banking — called by a
    scheduler running in a process WITHOUT a driver/worker context (a
    standalone `rtpu start` node), where no flusher can deliver.  With a
    context present this returns [] and the flusher keeps ownership."""
    from ray_tpu_torch._private import worker as worker_mod

    if worker_mod.global_worker_or_none() is not None:
        return []
    with _ev_lock:
        batch = list(_ev_buf)
        del _ev_buf[:]
        for r in batch:
            r.pop("_buffered", None)
    return batch


def _ev_flush_interval() -> float:
    from ray_tpu_torch._private import flags

    return max(0.25, float(flags.get("RTPU_METRICS_FLUSH_S")))


def _ensure_ev_flusher() -> None:
    global _ev_flusher_started
    with _ev_lock:
        if _ev_flusher_started:
            return
        _ev_flusher_started = True
    threading.Thread(target=_ev_flush_loop, name="events-flush",
                     daemon=True).start()


def _ev_flush_loop() -> None:
    while not _ev_flush_stop.wait(_ev_flush_interval()):
        try:
            flush_events()
        except Exception:
            pass
