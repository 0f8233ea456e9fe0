"""Trace spans: propagation, collection, assembly, and the runtime's flush.

Counterpart of ``ray_tpu/util/tracing/__init__.py``.  A trace context
(``trace_id``, parent ``span_id``) lives in thread-local state: a serving
entry point mints a root (``serving_span``), nested ``trace_span`` blocks
parent under it, and work handed across threads re-establishes the
captured context (``use_context``) or stamps spans with an explicit one
(``record_span``, the engine's scheduler thread).

Under the port's runtime a context also rides each ``TaskSpec``
(``attach_trace`` at submission, ``begin_task_span`` / ``end_task_span``
around execution in the worker), and a background flusher pushes every
span carrying a trace id to the node scheduler (``spans_push``).  Outside
a runtime the spans stay buffered until ``take_spans()`` drains them, and
``assemble_trace`` builds one tree per trace with its critical path.  The
chrome export draws cross-process flow arrows.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_spans: List[Dict[str, Any]] = []
_lock = threading.Lock()
_enabled = False

# Spans carrying a trace id queue here until the flusher pushes them to
# the node scheduler ("spans_push") or take_spans() drains them.  Bounded:
# tracing is observability, not ground truth.
_remote_buf: List[Dict[str, Any]] = []
_REMOTE_BUF_CAP = 50_000

_tls = threading.local()

_flusher_started = False
_flush_stop = threading.Event()
_flush_gen = 0


def enable_tracing() -> None:
    """Turn on app-span collection in this process (``trace_span`` then
    mints a root where no context is active)."""
    global _enabled
    _enabled = True


def disable_tracing() -> None:
    """Stop minting new root traces here (in-flight contexts still
    propagate; already-buffered spans stay buffered)."""
    global _enabled
    _enabled = False


def is_tracing_enabled() -> bool:
    return _enabled


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def current_context() -> Optional[Tuple[str, Optional[str]]]:
    """The calling thread's (trace_id, span_id), or None outside a trace."""
    return getattr(_tls, "ctx", None)


class Span:
    """Handle yielded by :func:`trace_span`: exposes the ids so callers can
    find the trace later.  Mutating ``attrs`` inside the block adds
    attributes resolved mid-span to the recorded span."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs: Dict[str, Any] = {}

    def __repr__(self):
        return f"Span({self.name!r}, trace_id={self.trace_id})"


def _record(rec: Dict[str, Any]) -> None:
    with _lock:
        _spans.append({
            "name": rec["name"], "ph": "X", "pid": rec["pid"],
            "tid": threading.get_ident() % 1_000_000,
            "ts": rec["start_ts"] * 1e6,
            "dur": (rec["end_ts"] - rec["start_ts"]) * 1e6,
            "args": dict(rec.get("args") or {},
                         **({"trace_id": rec["trace_id"],
                             "span_id": rec["span_id"]}
                            if rec.get("trace_id") else {})),
        })
        if rec.get("trace_id") and len(_remote_buf) < _REMOTE_BUF_CAP:
            _remote_buf.append(rec)
    if rec.get("trace_id") and _runtime_context() is not None:
        _ensure_flusher()


def _user_span(trace_id: str, span_id: str, parent_id: Optional[str],
               name: str, t0: float, args: Dict[str, Any]) -> None:
    end = time.time()
    _record({
        "trace_id": trace_id, "span_id": span_id, "parent_id": parent_id,
        "name": name, "kind": "user", "pid": os.getpid(),
        "start_ts": t0, "end_ts": end, "queue_wait_s": 0.0,
        "arg_fetch_s": 0.0, "run_s": end - t0, "ok": True, "args": args,
    })


@contextlib.contextmanager
def trace_span(name: str, **attributes):
    """Record one span.  Yields a :class:`Span` when a trace is active
    (tracing enabled here, or running inside a traced request) so nested
    spans parent under it; yields None when tracing is off."""
    ctx = getattr(_tls, "ctx", None)
    if not _enabled and ctx is None:
        yield None
        return
    trace_id = ctx[0] if ctx else new_trace_id()
    parent_id = ctx[1] if ctx else None
    span = Span(trace_id, new_span_id(), parent_id, name)
    _tls.ctx = (trace_id, span.span_id)
    t0 = time.time()
    try:
        yield span
    finally:
        _tls.ctx = ctx
        _user_span(trace_id, span.span_id, parent_id, name, t0,
                   dict(attributes, **span.attrs))


def sample_request() -> bool:
    """Head-sampling decision for a new serving root trace
    (``RTPU_TRACE_SAMPLE``, default 1.0).  Children of an existing trace
    always inherit — sampling happens only where roots are minted, so a
    sampled request is traced end to end and a dropped one costs nothing."""
    p = float(os.environ.get("RTPU_TRACE_SAMPLE", "1.0") or 1.0)
    if p >= 1.0:
        return True
    if p <= 0.0:
        return False
    return random.random() < p


@contextlib.contextmanager
def serving_span(name: str, **attributes):
    """Root entry point for a serving request (OpenAI server, P/D router).

    Unlike :func:`trace_span`, this mints a root even when tracing was
    never enabled in this process, but each new root passes the
    ``RTPU_TRACE_SAMPLE`` head sampler first.  Inside an existing trace it
    nests exactly like ``trace_span``; sampled-out requests yield None and
    record nothing."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None and not sample_request():
        yield None
        return
    with trace_span(name, **attributes) as span:
        if span is not None:
            yield span
            return
        # no ambient context and tracing disabled: mint the root ourselves
        trace_id = new_trace_id()
        span = Span(trace_id, new_span_id(), None, name)
        _tls.ctx = (trace_id, span.span_id)
        t0 = time.time()
        try:
            yield span
        finally:
            _tls.ctx = ctx
            _user_span(trace_id, span.span_id, None, name, t0,
                       dict(attributes, **span.attrs))


@contextlib.contextmanager
def use_context(ctx: Optional[Tuple[str, Optional[str]]]):
    """Re-establish a captured ``(trace_id, span_id)`` context on this
    thread — for work handed across threads (SSE generators, the P/D
    prefill→decode handoff) that should parent under the capture point."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def record_span(trace_id: str, name: str, start_ts: float, end_ts: float, *,
                parent_id: Optional[str] = None,
                span_id: Optional[str] = None, kind: str = "engine",
                ok: bool = True,
                attrs: Optional[Dict[str, Any]] = None) -> str:
    """Record a span with an explicit context instead of thread-local
    state.  The engine's scheduler thread interleaves many requests, so it
    carries each request's ``(trace_id, span_id)`` and stamps phase spans
    (queue, kv-pull, prefill, decode) here as they complete."""
    sid = span_id or new_span_id()
    _record({
        "trace_id": trace_id, "span_id": sid, "parent_id": parent_id,
        "name": name, "kind": kind, "pid": os.getpid(),
        "start_ts": start_ts, "end_ts": end_ts,
        "queue_wait_s": 0.0, "arg_fetch_s": 0.0,
        "run_s": max(0.0, end_ts - start_ts), "ok": ok,
        "args": dict(attrs or {}),
    })
    return sid


def attach_trace(spec) -> None:
    """Stamp a submission-side trace context onto a TaskSpec.

    Inside an active span (a driver ``trace_span`` block or a traced
    task's execution) the spec inherits that context; otherwise, when
    tracing is enabled in this process, each ``.remote()`` mints a fresh
    root trace.  The stamped fields pickle through every submission lane.
    """
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        if not _enabled:
            return
        ctx = (new_trace_id(), None)
    spec.trace_id, spec.parent_span_id = ctx
    spec.trace_submit_ts = time.time()


# ---------------------------------------------------------------------------
# built-in task-execution spans (the runtime's worker_main drives these)

def begin_task_span(spec, start_ts: Optional[float] = None) -> Optional[dict]:
    """Open the built-in execution span for a traced TaskSpec: establishes
    the thread's trace context (so nested submissions parent here) and
    returns a token for :func:`end_task_span`.  None for untraced specs."""
    trace_id = getattr(spec, "trace_id", None)
    if not trace_id:
        return None
    token = {
        "trace_id": trace_id, "span_id": new_span_id(),
        "parent_id": getattr(spec, "parent_span_id", None),
        "name": spec.name or (spec.method_name or spec.kind),
        "kind": spec.kind, "pid": os.getpid(),
        "submit_ts": getattr(spec, "trace_submit_ts", 0.0) or None,
        "start_ts": start_ts if start_ts is not None else time.time(),
        "arg_fetch_s": 0.0,
        "prev_ctx": getattr(_tls, "ctx", None),
        "prev_token": getattr(_tls, "task_token", None),
    }
    _tls.ctx = (trace_id, token["span_id"])
    _tls.task_token = token
    return token


def note_arg_fetch(seconds: float) -> None:
    """Charge dependency-resolution time to the current task span."""
    token = getattr(_tls, "task_token", None)
    if token is not None:
        token["arg_fetch_s"] += seconds


def end_task_span(token: Optional[dict], ok: bool = True,
                  flush: bool = True) -> None:
    """Close a task-execution span, restore the previous context, and (by
    default) flush pending spans to the node scheduler right away so the
    trace is queryable as soon as the task finishes."""
    if token is None:
        return
    _tls.ctx = token.pop("prev_ctx")
    _tls.task_token = token.pop("prev_token")
    end_ts = time.time()
    start_ts = token.pop("start_ts")
    submit_ts = token.pop("submit_ts")
    arg_fetch = token.pop("arg_fetch_s")
    queue_wait = max(0.0, start_ts - submit_ts) if submit_ts else 0.0
    _record(dict(token, submit_ts=submit_ts, start_ts=start_ts,
                 end_ts=end_ts, ok=ok,
                 queue_wait_s=queue_wait, arg_fetch_s=arg_fetch,
                 run_s=max(0.0, (end_ts - start_ts) - arg_fetch),
                 args={}))
    if flush:
        flush_spans()


# ---------------------------------------------------------------------------
# flush plane: spans -> node scheduler ("spans_push", like metrics_push)

def _runtime_context():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.global_worker_or_none()


def flush_spans() -> int:
    """Push queued spans to the node scheduler; returns how many landed.
    Without a runtime in this process nothing is taken, so ``take_spans``
    still sees every span.  Best-effort: on failure the batch re-queues
    for the next attempt."""
    ctx = _runtime_context()
    if ctx is None:
        return 0
    with _lock:
        if not _remote_buf:
            return 0
        batch = list(_remote_buf)
        del _remote_buf[:]
    try:
        ctx.rpc("spans_push", {"spans": batch})
        return len(batch)
    except Exception:
        with _lock:
            _remote_buf[:0] = batch[:_REMOTE_BUF_CAP - len(_remote_buf)]
        return 0


def _flush_interval() -> float:
    from ray_tpu_torch._private import flags

    return max(0.25, float(flags.get("RTPU_METRICS_FLUSH_S")))


def _ensure_flusher() -> None:
    global _flusher_started, _flush_gen
    with _lock:
        if _flusher_started:
            return
        _flusher_started = True
        _flush_gen += 1
        gen = _flush_gen
        _flush_stop.clear()
    threading.Thread(target=_flush_loop, args=(gen,), name="trace-flush",
                     daemon=True).start()


def _flush_loop(gen: int) -> None:
    global _flusher_started
    while True:
        stopped = _flush_stop.wait(_flush_interval())
        with _lock:
            if gen != _flush_gen:
                return  # superseded by a newer flusher
            if stopped:
                _flusher_started = False
                return
        try:
            flush_spans()
        except Exception:
            pass


def shutdown_flusher(flush: bool = False) -> None:
    """Stop the background span flusher (clean worker/driver shutdown);
    optionally pushing one final batch first."""
    if flush:
        try:
            flush_spans()
        except Exception:
            pass
    _flush_stop.set()


def take_spans() -> List[Dict[str, Any]]:
    """Drain the buffered span records (each with ``trace_id``,
    ``span_id``, ``parent_id``, ``name``, ``start_ts``, ``end_ts``, ...),
    oldest first; group them by ``trace_id`` for :func:`assemble_trace`."""
    with _lock:
        batch = list(_remote_buf)
        del _remote_buf[:]
    return batch


# ---------------------------------------------------------------------------
# trace assembly + critical path (pure functions)

def assemble_trace(trace_id: str, spans: List[dict]) -> dict:
    """Merge span lists into one tree with a critical-path summary.
    Tolerates duplicates and orphans (parent span not collected: the child
    becomes a root)."""
    by_id: Dict[str, dict] = {}
    for s in spans:
        sid = s.get("span_id")
        if sid and sid not in by_id:
            by_id[sid] = s
    flat = sorted(by_id.values(), key=lambda s: s.get("start_ts") or 0.0)
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in flat:
        pid = s.get("parent_id")
        if pid and pid in by_id:
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)

    def _node(s: dict) -> dict:
        return dict(s, children=[_node(c)
                                 for c in children.get(s["span_id"], ())])

    tree = [_node(r) for r in roots]

    critical: List[dict] = []
    if flat:
        cur = max(roots, key=lambda s: s.get("end_ts") or 0.0)
        while cur is not None:
            critical.append(cur)
            kids = children.get(cur["span_id"])
            cur = max(kids, key=lambda s: s.get("end_ts") or 0.0) \
                if kids else None

    def _tot(key: str) -> float:
        return sum(s.get(key) or 0.0 for s in critical)

    summary = {
        "trace_id": trace_id,
        "num_spans": len(flat),
        "num_processes": len({(s.get("node"), s.get("pid")) for s in flat}),
        "wall_s": (max(s.get("end_ts") or 0.0 for s in flat)
                   - min(s.get("start_ts") or 0.0 for s in flat))
        if flat else 0.0,
        "queue_wait_s": _tot("queue_wait_s"),
        "arg_fetch_s": _tot("arg_fetch_s"),
        "run_s": _tot("run_s"),
        "critical_path": [{
            "name": s.get("name"), "span_id": s.get("span_id"),
            "kind": s.get("kind"), "node": s.get("node"),
            "pid": s.get("pid"),
            "dur_s": (s.get("end_ts") or 0.0) - (s.get("start_ts") or 0.0),
            "queue_wait_s": s.get("queue_wait_s") or 0.0,
            "arg_fetch_s": s.get("arg_fetch_s") or 0.0,
            "run_s": s.get("run_s") or 0.0,
        } for s in critical],
    }
    return {"trace_id": trace_id, "spans": flat, "tree": tree,
            "summary": summary}


def trace_to_chrome_events(spans: List[dict]) -> List[dict]:
    """Chrome-trace events for one trace: an "X" slice per span grouped by
    (node, pid), plus flow events (``ph:"s"/"f"``) wherever a child span
    runs in a different process than its parent — Perfetto renders those
    as cross-process arrows."""
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    events: List[dict] = []

    def _proc(s: dict) -> str:
        node = s.get("node") or "?"
        return f"{str(node)[:8]}/pid{s.get('pid')}"

    for s in by_id.values():
        start = s.get("start_ts") or 0.0
        end = s.get("end_ts") or start
        events.append({
            "name": s.get("name"), "cat": s.get("kind") or "span",
            "ph": "X", "pid": _proc(s), "tid": s.get("pid") or 0,
            "ts": start * 1e6, "dur": max(end - start, 1e-6) * 1e6,
            "args": {
                "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                "queue_wait_s": s.get("queue_wait_s"),
                "arg_fetch_s": s.get("arg_fetch_s"),
                "run_s": s.get("run_s"), "ok": s.get("ok"),
            },
        })
        parent = by_id.get(s.get("parent_id") or "")
        if parent is None:
            continue
        if (parent.get("node"), parent.get("pid")) == \
                (s.get("node"), s.get("pid")):
            continue
        flow_id = int(s["span_id"][:8], 16)
        p_start = parent.get("start_ts") or 0.0
        p_end = parent.get("end_ts") or p_start
        s_ts = min(max(s.get("submit_ts") or start, p_start), p_end)
        events.append({"name": "submit", "cat": "flow", "ph": "s",
                       "id": flow_id, "pid": _proc(parent),
                       "tid": parent.get("pid") or 0, "ts": s_ts * 1e6})
        events.append({"name": "submit", "cat": "flow", "ph": "f",
                       "bp": "e", "id": flow_id, "pid": _proc(s),
                       "tid": s.get("pid") or 0, "ts": start * 1e6})
    events.sort(key=lambda e: e["ts"])
    return events


def export_trace_chrome_trace(trace: dict, path: str) -> int:
    """Write an assembled trace as a chrome trace with cross-process flow
    arrows; returns the event count."""
    events = trace_to_chrome_events(trace.get("spans") or [])
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return len(events)


def collected_spans() -> List[Dict[str, Any]]:
    """Every span recorded in this process, as chrome-trace "X" events."""
    with _lock:
        return list(_spans)


def export_chrome_trace(path: str, include_task_events: bool = True) -> int:
    """Write the collected spans (and, under a runtime, the node's task
    timeline) as a chrome trace; returns the event count.  Open in
    chrome://tracing or Perfetto."""
    events = collected_spans()
    if include_task_events and _runtime_context() is not None:
        try:
            from ray_tpu_torch._private.worker import global_worker

            for e in global_worker().rpc("list_task_events", {}):
                # FORWARDED is a hand-off record on the forwarding node;
                # the executing node logs the same task again — skip, as
                # state.events_to_chrome_trace does, or every spilled task
                # shows up twice.
                if e.get("state") == "FORWARDED":
                    continue
                if e.get("start_ts") and e.get("end_ts"):
                    events.append({
                        "name": e["name"], "ph": "X", "pid": 1,
                        "tid": int.from_bytes(
                            e["task_id"][:4], "little") % 1_000_000,
                        "ts": e["start_ts"] * 1e6,
                        "dur": (e["end_ts"] - e["start_ts"]) * 1e6,
                        "args": {"state": e["state"]},
                    })
        except Exception:
            pass
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return len(events)


def export_otel_spans(tracer=None):
    """Replay collected spans into an OpenTelemetry tracer (import-gated
    like the reference's exporters, tracing_helper.py): each recorded span
    becomes an OTel span with its original timestamps and attributes.
    Returns the number of spans exported.  Without the opentelemetry
    package use export_chrome_trace() for local inspection."""
    try:
        from opentelemetry import trace as otel_trace
    except ImportError as e:
        raise ImportError(
            "opentelemetry is not installed; use export_chrome_trace() "
            "for local trace inspection") from e
    if tracer is None:
        provider = otel_trace.get_tracer_provider()
        if type(provider).__name__ in ("NoOpTracerProvider",
                                       "ProxyTracerProvider"):
            # no SDK configured: spans would be NonRecording and silently
            # vanish — misreporting them as exported helps nobody
            raise RuntimeError(
                "no OpenTelemetry TracerProvider is configured; call "
                "opentelemetry.trace.set_tracer_provider(...) first or "
                "pass an explicit tracer")
        tracer = otel_trace.get_tracer("ray_tpu_torch")
    spans = collected_spans()
    for s in spans:
        start_ns = int(s["ts"] * 1e3)  # recorded in microseconds
        end_ns = int((s["ts"] + s["dur"]) * 1e3)
        span = tracer.start_span(s["name"], start_time=start_ns)
        for k, v in (s.get("args") or {}).items():
            # OTel silently drops non-primitive values (set_attribute
            # never raises): sanitize up front so nothing vanishes
            span.set_attribute(
                str(k), v if isinstance(v, (bool, str, int, float))
                else repr(v))
        span.end(end_time=end_ns)
    return len(spans)
