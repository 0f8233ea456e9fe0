"""Cluster-wide sampling profiler + device telemetry.

The profiling plane mirrors the spans/metrics planes (util/tracing,
util/metrics): every worker and driver runs an in-process sampling
profiler — a stdlib-only daemon thread walking ``sys._current_frames()``
at ``RTPU_PROFILE_HZ`` — that aggregates samples into folded stacks keyed
by the currently-executing task's name and trace id (so profiles join up
with distributed traces), and flushes them to the node scheduler over the
control socket (``profiles_push``, the spans_push of CPU samples).  The
reference pairs its timeline with py-spy dumps (`ray stack`,
scripts.py:2683) and dashboard flamegraphs; here the profiler is native
to the runtime, so stacks carry task attribution for free.

Two modes share one sampler thread:

- **continuous**: low-rate always-on profiling (default 10 Hz; 0
  disables), flushed every ``RTPU_PROFILE_FLUSH_S`` under the well-known
  profile id ``"continuous"`` — the cluster always has a recent answer to
  "where is CPU time going".
- **capture**: on-demand high-rate recording (``rtpu profile --record``,
  ``util.state.record_profile``) under a caller-chosen profile id,
  started/stopped by the scheduler's ``profile_start``/``profile_stop``
  fan-out over per-worker profiler control connections.

The control connection is the piece that makes live inspection work: the
worker main loop executes tasks inline, so a busy worker cannot service
control messages on its primary scheduler connection.  Each worker opens
a SECOND persistent connection (``profiler_register``) serviced by a
dedicated thread, which handles start/stop/dump even mid-task — this is
also what upgrades `rtpu stack` from "see the worker's stderr" to
returning live thread stacks to the caller (``dump_stacks``).

Device telemetry rides the sampler thread: per-device bytes in use and
their peak from ``torch.cuda.memory_stats()``, and the count and seconds
of the CUDA kernel builds this process ran (``ops/_build.py``), exported
as ``util.metrics`` series.  It only reads once this process has a CUDA
context (``torch.cuda.is_initialized()``): a profiler tick never creates
one, so a worker that never touched the card spends none of its memory.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

# Folded-stack entries (distinct stacks) retained per profile, both in the
# per-process accumulators and the scheduler's banked store: one runaway
# capture can't eat the node.  Counts keep accumulating for known stacks.
FOLDED_ENTRY_CAP = 20_000

# Frames deeper than this are truncated (recursion guards the sampler).
_MAX_DEPTH = 128

_TELEMETRY_PERIOD_S = 2.0

# ---------------------------------------------------------------------------
# task attribution: thread ident -> (task name, trace id)
#
# worker_main brackets task execution with note_task/clear_task so every
# sample lands under the task it ran for (plain dict: assignment/deletion
# are atomic under the GIL; the sampler only .get()s).

_thread_tasks: Dict[int, Tuple[str, Optional[str]]] = {}

# Sidecar attribution file (worker processes only): the pool points
# RTPU_TASK_ATTR_PATH at logs/worker-<id8>.task, and the note_task bracket
# mirrors "what this worker executes NOW" there so the node's log monitor
# can tag captured stdout/stderr lines with task + trace.  A scheduler-side
# view can't do this: plain tasks dispatch on the native raylet lane and
# never enter the Python in_flight table.  Kept to two syscalls per task
# (ftruncate+pwrite on a cached fd) so microtask throughput is untouched.
_attr_fd: Optional[int] = None
_attr_lock = threading.Lock()


def _write_task_attr(name: str, task_id: str, trace_id: str) -> None:
    global _attr_fd
    path = os.environ.get("RTPU_TASK_ATTR_PATH")
    if not path:
        return
    try:
        with _attr_lock:
            if _attr_fd is None:
                _attr_fd = os.open(path,
                                   os.O_WRONLY | os.O_CREAT, 0o644)
            data = f"{name}\t{task_id}\t{trace_id}\n".encode(
                "utf-8", "replace")
            os.ftruncate(_attr_fd, 0)
            os.pwrite(_attr_fd, data, 0)
    except OSError:
        pass  # attribution is best-effort; never fail the task for it


def note_task(spec) -> Optional[tuple]:
    """Attribute the calling thread's samples to ``spec`` until
    :func:`clear_task`; returns a token restoring the previous owner
    (concurrent-actor pools reuse threads across tasks)."""
    ident = threading.get_ident()
    prev = _thread_tasks.get(ident)
    name = (getattr(spec, "name", None) or getattr(spec, "method_name", None)
            or getattr(spec, "kind", None) or "task")
    _thread_tasks[ident] = (str(name), getattr(spec, "trace_id", None))
    tid = getattr(spec, "task_id", None)
    _write_task_attr(str(name), tid.hex() if tid else "",
                     getattr(spec, "trace_id", None) or "")
    return (ident, prev)


def clear_task(token: Optional[tuple]) -> None:
    if token is None:
        return
    ident, prev = token
    if prev is None:
        _thread_tasks.pop(ident, None)
        _write_task_attr("", "", "")
    else:
        _thread_tasks[ident] = prev
        _write_task_attr(prev[0], "", prev[1] or "")


def current_task(ident: Optional[int] = None) -> Optional[tuple]:
    return _thread_tasks.get(
        threading.get_ident() if ident is None else ident)


# ---------------------------------------------------------------------------
# stack collection

def _collect_stacks(skip_idents=()) -> List[Tuple[tuple, str]]:
    """One sample: [((attribution_key), folded_stack_str), ...] for every
    live thread.  Frames render root-first as ``file:func:firstlineno`` —
    co_firstlineno (not f_lineno) keeps the aggregation key stable across
    samples of the same function."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: List[Tuple[tuple, str]] = []
    for tid, frame in sys._current_frames().items():
        if tid in skip_idents:
            continue
        stack: List[str] = []
        f = frame
        while f is not None and len(stack) < _MAX_DEPTH:
            co = f.f_code
            stack.append(f"{os.path.basename(co.co_filename)}:"
                         f"{co.co_name}:{co.co_firstlineno}")
            f = f.f_back
        stack.reverse()  # root first, like folded flamegraph input
        task = _thread_tasks.get(tid)
        if task is not None:
            key = task
        else:
            key = (f"thread:{names.get(tid) or tid}", None)
        out.append((key, ";".join(stack)))
    return out


def dump_stacks() -> str:
    """Human-readable stacks of every thread in THIS process, with task
    attribution — the payload behind `rtpu stack` (reference: py-spy
    dumps; here first-party, so no ptrace and no external binary)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    frames = sys._current_frames()
    parts = [f"pid {os.getpid()}: {len(frames)} threads"]
    for tid, frame in sorted(frames.items()):
        hdr = f"-- thread {names.get(tid, '?')} (ident {tid})"
        task = _thread_tasks.get(tid)
        if task is not None:
            hdr += f" [task {task[0]}"
            if task[1]:
                hdr += f" trace {task[1]}"
            hdr += "]"
        parts.append(hdr)
        parts.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(parts)


class _FoldedStore:
    """Folded-stack accumulator: (task, trace_id) -> {stack: count},
    bounded at FOLDED_ENTRY_CAP distinct stacks."""

    __slots__ = ("groups", "entries", "samples")

    def __init__(self):
        self.groups: Dict[tuple, Dict[str, int]] = {}
        self.entries = 0
        self.samples = 0

    def bump(self, key: tuple, stack: str) -> None:
        g = self.groups.get(key)
        if g is None:
            g = self.groups[key] = {}
        if stack in g:
            g[stack] += 1
        elif self.entries < FOLDED_ENTRY_CAP:
            g[stack] = 1
            self.entries += 1

    def to_stacks(self) -> List[dict]:
        return [{"task": k[0], "trace_id": k[1], "folded": dict(g)}
                for k, g in self.groups.items()]


# ---------------------------------------------------------------------------
# device telemetry (rides the sampler thread)

class _DeviceTelemetry:
    """CUDA memory and kernel-build telemetry as util.metrics series.

    Never initializes CUDA: it reads only when this process already holds
    a CUDA context (``torch.cuda.is_initialized()``), so a profiler thread
    can't spend a context's device memory in a worker that never used the
    card.  Without one it registers nothing (the no-op-safe path)."""

    # Family names, each a prefix plus a suffix like the rest of the port's.
    PREFIX = "cuda_"
    IN_USE = PREFIX + "device_memory_bytes_in_use"
    PEAK = PREFIX + "device_memory_peak_bytes"
    BUILDS = PREFIX + "kernel_builds_total"
    BUILD_SECONDS = PREFIX + "kernel_build_seconds_total"

    def __init__(self):
        self._mem_gauges = None
        self._build_counters = None
        self._builds_seen = {"count": 0, "seconds": 0.0}

    def _ensure_mem_gauges(self):
        if self._mem_gauges is None:
            from ray_tpu_torch.util import metrics as metrics_mod

            pid = str(os.getpid())
            self._mem_gauges = (
                metrics_mod.Gauge(
                    self.IN_USE,
                    "Live bytes the caching allocator holds for tensors "
                    "(memory_stats allocated_bytes.all.current)",
                    ("device", "pid")).set_default_tags({"pid": pid}),
                metrics_mod.Gauge(
                    self.PEAK,
                    "Peak bytes the caching allocator held for tensors "
                    "(memory_stats allocated_bytes.all.peak)",
                    ("device", "pid")).set_default_tags({"pid": pid}),
            )
        return self._mem_gauges

    def _ensure_build_counters(self):
        if self._build_counters is None:
            from ray_tpu_torch.util import metrics as metrics_mod

            pid = str(os.getpid())
            self._build_counters = (
                metrics_mod.Counter(
                    self.BUILDS,
                    "CUDA kernel libraries this process compiled with nvcc",
                    ("pid",)).set_default_tags({"pid": pid}),
                metrics_mod.Counter(
                    self.BUILD_SECONDS,
                    "Wall seconds of this process's nvcc builds",
                    ("pid",)).set_default_tags({"pid": pid}),
            )
        return self._build_counters

    def _tick_builds(self) -> None:
        build_mod = sys.modules.get("ray_tpu_torch.ops._build")
        stats = (build_mod.build_stats() if build_mod is not None
                 else {"count": 0, "seconds": 0.0})
        count, secs = self._ensure_build_counters()
        seen = self._builds_seen
        if stats["count"] > seen["count"]:
            count.inc(float(stats["count"] - seen["count"]))
        if stats["seconds"] > seen["seconds"]:
            secs.inc(float(stats["seconds"] - seen["seconds"]))
        self._builds_seen = dict(stats)
        if not count._snapshot()["values"]:
            count.inc(0.0)  # a series that reads 0, not an absent one
            secs.inc(0.0)

    def tick(self) -> None:
        torch = sys.modules.get("torch")
        if torch is None:
            return  # this process never imported torch: nothing to observe
        try:
            if not torch.cuda.is_initialized():
                return  # no CUDA context here: don't create one
            n = torch.cuda.device_count()
        except Exception:
            return
        in_use, peak = self._ensure_mem_gauges()
        for d in range(n):
            try:
                stats = torch.cuda.memory_stats(d)
            except Exception:
                continue
            tags = {"device": str(d)}
            v = stats.get("allocated_bytes.all.current")
            if v is not None:
                in_use.set(float(v), tags)
            v = stats.get("allocated_bytes.all.peak")
            if v is not None:
                peak.set(float(v), tags)
        self._tick_builds()


# ---------------------------------------------------------------------------
# the sampler

class Sampler:
    """One per process: samples all threads, accumulates folded stacks,
    flushes the continuous profile, and runs the device-telemetry tick."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._capture: Optional[dict] = None
        self._cont = _FoldedStore()
        self._cont_t0 = time.time()
        self._last_flush = time.monotonic()
        self._last_telemetry = 0.0
        self.telemetry = _DeviceTelemetry()

    # -- config reads (flags registry, re-read so env changes apply live) --
    @staticmethod
    def _base_hz() -> float:
        from ray_tpu_torch._private import flags

        try:
            return min(1000.0, float(flags.get("RTPU_PROFILE_HZ")))
        except Exception:
            return 10.0

    @staticmethod
    def _flush_interval() -> float:
        from ray_tpu_torch._private import flags

        try:
            return max(0.25, float(flags.get("RTPU_PROFILE_FLUSH_S")))
        except Exception:
            return 5.0

    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="rtpu-profiler", daemon=True)
            self._thread.start()

    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def shutdown(self, flush: bool = False) -> None:
        if flush:
            try:
                self.flush_continuous()
            except Exception:
                pass
        self._stop.set()

    # -- capture mode ------------------------------------------------------
    def start_capture(self, profile_id: str, hz: float = 99.0) -> bool:
        """Begin a high-rate recording; idempotent for the same id (the
        driver process hosts every in-process node's scheduler, so a
        cluster-wide fan-out may reach the same sampler repeatedly)."""
        hz = min(1000.0, max(1.0, float(hz)))
        with self._lock:
            if self._capture is not None:
                return self._capture["profile_id"] == profile_id
            self._capture = {"profile_id": profile_id, "hz": hz,
                             "t0": time.time(), "store": _FoldedStore()}
            return True

    def stop_capture(self, profile_id: Optional[str] = None) -> List[dict]:
        """End the capture and return its records (``profiles_push``
        shape); [] when no matching capture is active."""
        with self._lock:
            cap = self._capture
            if cap is None or (profile_id is not None
                               and cap["profile_id"] != profile_id):
                return []
            self._capture = None
        store = cap["store"]
        if not store.samples:
            return []
        return [{
            "profile_id": cap["profile_id"],
            "pid": os.getpid(),
            "hz": cap["hz"],
            "t0": cap["t0"],
            "t1": time.time(),
            "samples": store.samples,
            "stacks": store.to_stacks(),
        }]

    def capturing(self) -> Optional[str]:
        with self._lock:
            return self._capture["profile_id"] if self._capture else None

    # -- continuous flush --------------------------------------------------
    def flush_continuous(self) -> bool:
        """Push accumulated always-on samples under profile id
        "continuous".  Best-effort: on failure (or no driver/worker
        context yet) the accumulator is kept for the next attempt."""
        with self._lock:
            store = self._cont
            if not store.samples:
                return False
            t0 = self._cont_t0
        rec = {
            "profile_id": "continuous",
            "pid": os.getpid(),
            "hz": self._base_hz(),
            "t0": t0,
            "t1": time.time(),
            "samples": store.samples,
            "stacks": store.to_stacks(),
        }
        from ray_tpu_torch._private import worker as worker_mod

        ctx = worker_mod.global_worker_or_none()
        if ctx is None:
            return False
        try:
            ctx.rpc("profiles_push", {"records": [rec]})
        except Exception:
            return False
        with self._lock:
            if self._cont is store:  # nobody swapped it meanwhile
                self._cont = _FoldedStore()
                self._cont_t0 = time.time()
        return True

    # -- the loop ----------------------------------------------------------
    def _take_sample(self) -> None:
        with self._lock:
            cap = self._capture
        skip = {self._thread.ident} if self._thread else ()
        entries = _collect_stacks(skip)
        with self._lock:
            if cap is not None and self._capture is cap:
                store = cap["store"]
            elif cap is None and self._base_hz() > 0:
                store = self._cont
            else:
                return
            store.samples += 1
            for key, stack in entries:
                store.bump(key, stack)

    def _loop(self) -> None:
        while True:
            with self._lock:
                cap = self._capture
            hz = cap["hz"] if cap is not None else self._base_hz()
            interval = 1.0 / hz if hz > 0 else 0.5
            if self._stop.wait(interval):
                return
            if hz > 0:
                try:
                    self._take_sample()
                except Exception:
                    pass  # sampling must never kill the thread
            now = time.monotonic()
            if now - self._last_flush >= self._flush_interval():
                self._last_flush = now
                try:
                    self.flush_continuous()
                except Exception:
                    pass
            if now - self._last_telemetry >= _TELEMETRY_PERIOD_S:
                self._last_telemetry = now
                try:
                    self.telemetry.tick()
                except Exception:
                    pass


_sampler: Optional[Sampler] = None
_sampler_lock = threading.Lock()


def get_sampler() -> Sampler:
    """The process-wide sampler, (re)started on demand — a fresh
    ray_tpu_torch.init() after shutdown() in the same process resumes it."""
    global _sampler
    with _sampler_lock:
        if _sampler is None or not _sampler.alive():
            s = _sampler if _sampler is not None else Sampler()
            _sampler = s
    _sampler.start()
    return _sampler


ensure_sampler = get_sampler


def shutdown_sampler(flush: bool = False) -> None:
    with _sampler_lock:
        s = _sampler
    if s is not None:
        s.shutdown(flush=flush)
    _ctl_stop.set()


# ---------------------------------------------------------------------------
# worker-side profiler control channel
#
# A second persistent connection to the node scheduler, serviced by its own
# thread: profile_start/stop and stack dumps work even while the worker's
# main loop is busy executing a task.

_ctl_stop = threading.Event()


def start_worker_profiler(scheduler_socket: str, worker_id: bytes) -> None:
    _ctl_stop.clear()
    ensure_sampler()
    threading.Thread(
        target=_ctl_loop, args=(scheduler_socket, worker_id),
        name="rtpu-profiler-ctl", daemon=True).start()


def _ctl_loop(scheduler_socket: str, worker_id: bytes) -> None:
    from ray_tpu_torch._private import protocol

    backoff = 0.2
    while not _ctl_stop.is_set():
        try:
            conn = protocol.connect_addr(scheduler_socket)
            conn.send({"t": "profiler_register",
                       "worker_id": worker_id.hex()})
        except Exception:
            if _ctl_stop.wait(backoff):
                return
            backoff = min(2.0, backoff * 2)
            continue
        backoff = 0.2
        try:
            while True:
                msg = conn.recv()
                if msg is None:
                    break
                try:
                    _handle_ctl(conn, msg, worker_id)
                except Exception:
                    pass  # a bad ctl op must not drop the channel
        except (OSError, ConnectionError, EOFError):
            pass
        finally:
            try:
                conn.close()
            except Exception:
                pass
        if _ctl_stop.wait(backoff):
            return


def _handle_ctl(conn, msg: dict, worker_id: bytes) -> None:
    if msg.get("t") != "profile_ctl":
        return
    op = msg.get("op")
    if op == "start":
        get_sampler().start_capture(msg["profile_id"],
                                    float(msg.get("hz") or 99.0))
    elif op == "stop":
        records = get_sampler().stop_capture(msg.get("profile_id"))
        conn.send({"t": "profile_reply", "op": "stop",
                   "profile_id": msg.get("profile_id"),
                   "pid": os.getpid(), "worker_id": worker_id.hex(),
                   "records": records})
    elif op == "dump":
        conn.send({"t": "profile_reply", "op": "dump",
                   "req_id": msg.get("req_id"),
                   "pid": os.getpid(), "worker_id": worker_id.hex(),
                   "text": dump_stacks()})


# ---------------------------------------------------------------------------
# pure helpers shared by state.py, the dashboard, and the CLI

def merge_profiles(parts: List[Optional[dict]]) -> Optional[dict]:
    """Merge per-node ``get_profile`` results (same profile id) into one
    cluster-wide profile: stack groups union by (task, trace_id), folded
    counts sum."""
    parts = [p for p in parts if p]
    if not parts:
        return None
    groups: Dict[tuple, Dict[str, int]] = {}
    for p in parts:
        for grp in p.get("stacks") or ():
            key = (grp.get("task"), grp.get("trace_id"))
            g = groups.setdefault(key, {})
            for stack, n in (grp.get("folded") or {}).items():
                g[stack] = g.get(stack, 0) + n
    return {
        "profile_id": parts[0].get("profile_id"),
        "hz": parts[0].get("hz"),
        "t0": min(p.get("t0") or 0.0 for p in parts),
        "t1": max(p.get("t1") or 0.0 for p in parts),
        "samples": sum(p.get("samples") or 0 for p in parts),
        "nodes": sorted({str(p.get("node")) for p in parts
                         if p.get("node")}),
        "stacks": [{"task": k[0], "trace_id": k[1], "folded": g}
                   for k, g in groups.items()],
    }


def merge_profile_rows(rows: List[dict]) -> List[dict]:
    """Merge per-node ``list_profiles`` rows by profile id (most recent
    first) — the cluster-wide listing."""
    out: Dict[str, dict] = {}
    for r in rows:
        pid_ = r.get("profile_id")
        agg = out.get(pid_)
        if agg is None:
            out[pid_] = dict(r, tasks=sorted(r.get("tasks") or ()))
        else:
            agg["samples"] += r.get("samples") or 0
            agg["t0"] = min(agg["t0"], r.get("t0") or agg["t0"])
            agg["t1"] = max(agg["t1"], r.get("t1") or agg["t1"])
            agg["tasks"] = sorted(set(agg["tasks"])
                                  | set(r.get("tasks") or ()))
    return sorted(out.values(), key=lambda r: r.get("t1") or 0.0,
                  reverse=True)


def profile_to_folded(profile: dict) -> str:
    """Classic folded-stack text (``root;frame;frame count`` per line),
    rooted at the task name — feed to flamegraph.pl or speedscope."""
    lines = []
    for grp in profile.get("stacks") or ():
        root = grp.get("task") or "?"
        for stack, n in sorted((grp.get("folded") or {}).items()):
            lines.append(f"{root};{stack} {n}")
    return "\n".join(lines) + ("\n" if lines else "")


def profile_to_speedscope(profile: dict) -> dict:
    """speedscope file-format JSON (sampled profile, weights = sample
    counts): https://www.speedscope.app loads it directly."""
    frames: List[dict] = []
    index: Dict[str, int] = {}

    def idx(name: str) -> int:
        i = index.get(name)
        if i is None:
            i = index[name] = len(frames)
            frames.append({"name": name})
        return i

    samples: List[List[int]] = []
    weights: List[int] = []
    for grp in profile.get("stacks") or ():
        root = idx(grp.get("task") or "?")
        for stack, n in (grp.get("folded") or {}).items():
            samples.append([root] + [idx(f) for f in stack.split(";") if f])
            weights.append(n)
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": profile.get("profile_id") or "profile",
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        }],
        "exporter": "ray_tpu",
    }


def top_functions(profile: dict, n: int = 15) -> List[dict]:
    """Leaf-frame ranking: [{frame, count, fraction}], heaviest first."""
    leaf: Dict[str, int] = {}
    total = 0
    for grp in profile.get("stacks") or ():
        for stack, c in (grp.get("folded") or {}).items():
            fn = stack.rsplit(";", 1)[-1]
            leaf[fn] = leaf.get(fn, 0) + c
            total += c
    rows = sorted(leaf.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [{"frame": f, "count": c,
             "fraction": (c / total) if total else 0.0}
            for f, c in rows]
