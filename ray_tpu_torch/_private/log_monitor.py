"""Per-node worker-log monitor: tail worker stdout/stderr to the driver.

Counterpart of the reference's log monitor
(Ray's python/ray/_private/log_monitor.py): every worker process
writes its stdout/stderr to files under the session's ``logs/`` dir; this
monitor tails them and forwards new lines — prefixed with the producing
worker — through the scheduler to the driver, which prints them.  The
driver therefore sees ``print()`` output from tasks and actors on EVERY
node, exactly like the reference's ``(pid=..., ip=...)`` lines.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

POLL_S = 0.25
MAX_LINE = 8192
MAX_BATCH = 200  # lines per emit: bounds message size under log floods


class LogMonitor:
    """Tails every ``*.out``/``*.err`` file in ``logs_dir``.

    ``emit(lines)`` receives prefixed, newline-free strings.  Files are
    discovered continuously (workers spawn at any time); offsets persist
    per file so nothing is re-emitted.

    ``tasks`` (optional) maps each worker tag ("worker-<id8>") to its
    executing ``(task_name, task_id_hex, trace_id)`` at poll time — the
    scheduler's in-flight view of the same bracket worker_main drives
    via profiling.note_task.  Attributed lines gain a ``task=.. [trace]``
    suffix in the prefix and flow to ``emit_rows`` as structured records
    (the `rtpu logs --task` ring).  Attribution is sampled when the line
    is CAPTURED (within one POLL_S of being written), so a long-running
    task's output attributes correctly even mid-execution.
    """

    def __init__(self, logs_dir: str, emit: Callable[[List[str]], None],
                 tasks: Optional[
                     Callable[[], Dict[str, Tuple[str, str, str]]]] = None,
                 emit_rows: Optional[Callable[[List[dict]], None]] = None):
        self._dir = logs_dir
        self._emit = emit
        self._tasks = tasks
        self._emit_rows = emit_rows
        self._offsets: Dict[str, int] = {}
        self._partial: Dict[str, bytes] = {}
        self._partial_since: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="log-monitor", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                pass  # a transient fs error must not kill the tail
            self._stop.wait(POLL_S)

    def poll_once(self):
        if not os.path.isdir(self._dir):
            return
        now = time.monotonic()
        listing = sorted(os.listdir(self._dir))
        # one attribution snapshot per poll (not per line): the scheduler
        # closure first (Python-dispatched work), then each worker's
        # note_task sidecar file (covers the native raylet lane, which
        # never enters the Python in_flight table)
        tasks: Dict[str, Tuple[str, str, str]] = {}
        if self._tasks is not None:
            try:
                tasks = self._tasks() or {}
            except Exception:
                tasks = {}
        for name in listing:
            if not name.endswith(".task"):
                continue
            try:
                with open(os.path.join(self._dir, name), "rb") as f:
                    parts = f.read(MAX_LINE).decode(
                        "utf-8", "replace").rstrip("\n").split("\t")
            except OSError:
                continue
            if parts and parts[0]:
                tasks[name[:-len(".task")]] = (
                    parts[0],
                    parts[1] if len(parts) > 1 else "",
                    parts[2] if len(parts) > 2 else "")
        batch: List[str] = []
        rows: List[dict] = []
        for name in listing:
            if not (name.endswith(".out") or name.endswith(".err")):
                continue
            path = os.path.join(self._dir, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._offsets.get(name, 0)
            if size <= off:
                # A stale newline-less tail is a worker's dying words (C
                # aborts don't end in \n): flush it after a quiescence
                # window rather than holding it forever.
                if (name in self._partial
                        and now - self._partial_since.get(name, now)
                        > 4 * POLL_S):
                    tail_text = self._partial.pop(name).decode(
                        "utf-8", "replace")
                    self._partial_since.pop(name, None)
                    batch.append(self._capture(name, tail_text, tasks,
                                               rows))
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    data = self._partial.pop(name, b"") + f.read(
                        size - off)
            except OSError:
                continue
            self._offsets[name] = size
            *lines, tail = data.split(b"\n")
            if tail:
                self._partial[name] = tail[-MAX_LINE:]
                self._partial_since[name] = now
            else:
                self._partial_since.pop(name, None)
            for raw in lines:
                text = raw[-MAX_LINE:].decode("utf-8", "replace")
                if text.strip():
                    batch.append(self._capture(name, text, tasks, rows))
                if len(batch) >= MAX_BATCH:
                    self._emit(batch)
                    batch = []
        if batch:
            self._emit(batch)
        if rows and self._emit_rows is not None:
            try:
                self._emit_rows(rows)
            except Exception:
                pass

    def _capture(self, name: str, text: str,
                 tasks: Dict[str, Tuple[str, str, str]],
                 rows: List[dict]) -> str:
        tag = name.rsplit(".", 1)[0]  # worker-<id8>
        stream = "out" if name.endswith(".out") else "stderr"
        cur = tasks.get(tag)
        rows.append({
            "ts": time.time(), "worker": tag, "stream": stream,
            "line": text,
            "task": cur[0] if cur else None,
            "task_id": cur[1] if cur else None,
            "trace_id": cur[2] if cur else None,
        })
        return self._prefix(name, text, cur)

    @staticmethod
    def _prefix(name: str, text: str,
                cur: Optional[Tuple[str, str, str]] = None) -> str:
        tag = name.rsplit(".", 1)[0]  # worker-<id8>
        stream = "" if name.endswith(".out") else " stderr"
        if cur and cur[0]:
            return f"({tag}{stream} task={cur[0]}) {text}"
        return f"({tag}{stream}) {text}"
