"""Node memory monitor + worker-killing policy.

Counterpart of the reference's OOM handling: `MemoryMonitor`
(Ray's src/ray/common/memory_monitor.h:52 — cgroup-aware node
usage sampling on a timer) and the raylet worker-killing policies
(worker_killing_policy.h:39, retriable-FIFO worker_killing_policy_
retriable_fifo.cc, group-by-owner worker_killing_policy_group_by_owner.cc).

When node memory crosses the threshold, the scheduler kills ONE worker
chosen by policy instead of letting the kernel OOM-kill the raylet/store
daemon (which would take the whole node down).  The killed worker's
retriable tasks requeue through the normal worker-death path; a task that
exhausts retries surfaces ``OutOfMemoryError`` with provenance (rss at
kill, node usage, threshold) instead of a generic crash.

Kill policy (mirrors retriable-FIFO): prefer workers running RETRIABLE
tasks, newest task first (cheapest work lost, and the retry bill is paid by
a task that opted into retries); among non-retriable, newest first;
actor-hosting workers last (killing an actor loses state and burns restart
budget).  Workers with nothing in flight are never killed — idle pool
workers hold no user memory worth reclaiming relative to the churn.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional


def node_memory_usage() -> tuple[int, int]:
    """(used_bytes, total_bytes) for this node, cgroup-aware.

    Prefers cgroup v2 limits (containerized nodes — the reference reads
    the same files, memory_monitor.cc), falling back to /proc/meminfo.
    """
    try:  # cgroup v2
        with open("/sys/fs/cgroup/memory.max") as f:
            limit_s = f.read().strip()
        if limit_s != "max":
            limit = int(limit_s)
            with open("/sys/fs/cgroup/memory.current") as f:
                current = int(f.read().strip())
            return current, limit
    except (OSError, ValueError):
        pass
    total = avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:
        return 0, 0
    return max(0, total - avail), total


def process_rss(pid: int) -> int:
    """Resident set size of one process, bytes (0 if gone)."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


def choose_victim(workers) -> Optional[object]:
    """Pick the worker to kill under memory pressure (retriable-FIFO).

    ``workers``: iterable of objects with .alive, .in_flight (task_id ->
    spec with .retries_left/.kind), .actor_id, .proc.  Returns the chosen
    worker or None (nothing killable).
    """
    def task_started(w):
        # newest in-flight task approximated by insertion order (dicts
        # preserve it); the last entry is the most recently dispatched
        return len(w.in_flight) + getattr(w, "native_inflight", 0)

    candidates = [
        w for w in workers
        if w.alive and w.proc is not None
        and (w.in_flight or getattr(w, "native_inflight", 0))]
    if not candidates:
        return None

    def rank(w):
        specs = list(w.in_flight.values())
        # Native-lane tasks count as retriable plain work: the orphan
        # reap applies the real per-spec retry policy after the kill.
        retriable = (getattr(w, "native_inflight", 0) > 0
                     or any(getattr(s, "retries_left", 0) > 0
                            for s in specs))
        is_actor = w.actor_id is not None
        # sort ascending; kill the FIRST: retriable plain workers first
        # (0), then non-retriable plain (1), then actors (2); newest
        # dispatch first within a class
        klass = (0 if retriable and not is_actor
                 else 1 if not is_actor else 2)
        return (klass, -task_started(w))

    return sorted(candidates, key=rank)[0]


class MemoryMonitor:
    """Samples node memory on a timer; fires the callback above threshold.

    The callback receives (used, total, threshold_fraction) and runs on
    the monitor thread — it must be quick (the scheduler's handler just
    signals a kill).  A kill is followed by a cooldown so one pressure
    episode doesn't massacre the whole pool before memory readings settle.
    """

    def __init__(self, threshold_fraction: float,
                 callback: Callable[[int, int, float], bool],
                 interval_s: float = 1.0,
                 cooldown_s: float = 5.0,
                 usage_fn: Callable[[], tuple] = node_memory_usage):
        self.threshold = threshold_fraction
        self._callback = callback
        self._interval = interval_s
        self._cooldown = cooldown_s
        self._usage_fn = usage_fn
        self._last_kill = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="memory-monitor", daemon=True)
            self._thread.start()

    def check_once(self) -> bool:
        """One sample + possible kill; returns True if the callback fired
        (public for deterministic tests)."""
        used, total = self._usage_fn()
        if total <= 0 or used / total < self.threshold:
            return False
        now = time.monotonic()
        if now - self._last_kill < self._cooldown:
            return False
        if self._callback(used, total, self.threshold):
            self._last_kill = now
            return True
        return False

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                self.check_once()
            except Exception:
                pass  # monitoring must never take the scheduler down

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
