"""Per-node dashboard agent: physical stats reporter.

Counterpart of the reference's per-node ``DashboardAgent``
(Ray's python/ray/dashboard/agent.py:22) — specifically its
reporter module (dashboard/modules/reporter/), which samples node CPU /
memory / disk / network and per-worker RSS and ships them to the head.

Here the agent is a sampling thread owned by each node's scheduler (the
scheduler already plays the agent's other roles: log serving, runtime-env
install, metrics snapshot).  The head aggregates every node's latest
sample via the ``node_physical_stats`` RPC into ``/api/node_stats`` and
the SPA's charts.  A short in-memory history ring lets the UI draw
utilization over time without a real TSDB.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional

from ray_tpu_torch._private.memory_monitor import node_memory_usage, process_rss

_SAMPLE_PERIOD_S = 2.0
_HISTORY = 150  # 5 min at 2s


def _read_cpu_times() -> tuple[float, float]:
    """(busy_jiffies, total_jiffies) from /proc/stat line 1."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()[1:]
        nums = [float(x) for x in parts]
        idle = nums[3] + (nums[4] if len(nums) > 4 else 0.0)  # idle+iowait
        total = sum(nums)
        return total - idle, total
    except (OSError, IndexError, ValueError):
        return 0.0, 0.0


def _read_net_bytes() -> tuple[int, int]:
    """(rx_bytes, tx_bytes) summed over non-loopback interfaces."""
    rx = tx = 0
    try:
        with open("/proc/net/dev") as f:
            for line in f.readlines()[2:]:
                name, _, rest = line.partition(":")
                if name.strip() == "lo":
                    continue
                cols = rest.split()
                rx += int(cols[0])
                tx += int(cols[8])
    except (OSError, IndexError, ValueError):
        pass
    return rx, tx


def _proc_cmd_name(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/comm") as f:
            return f.read().strip()
    except OSError:
        return ""


class NodeStatsReporter:
    """Samples node physical stats on a timer; ``latest()`` is the RPC body.

    ``workers_fn`` yields ``(pid, description)`` pairs for live workers so
    each sample carries per-worker RSS (what the reference's reporter gets
    from psutil; here straight from /proc).
    """

    def __init__(self, node_id: bytes,
                 workers_fn: Optional[Callable[[], Iterable]] = None,
                 mm_threshold: float = 0.0):
        self._node_id = node_id
        self._workers_fn = workers_fn or (lambda: ())
        self._mm_threshold = mm_threshold
        # Memory pressure as util.metrics gauges: the memory monitor's
        # inputs are visible on /metrics BEFORE a kill fires (node_id /
        # pid tags keep series from different nodes and processes
        # distinct — the dashboard's renderer sums same-label series).
        from ray_tpu_torch.util import metrics as metrics_mod

        nid = node_id.hex()[:12]
        self._g_mem_used = metrics_mod.Gauge(
            "node_mem_used_bytes", "Node memory in use (MemAvailable "
            "subtracted from MemTotal, what the memory monitor sees)",
            ("node_id",)).set_default_tags({"node_id": nid})
        self._g_mem_total = metrics_mod.Gauge(
            "node_mem_total_bytes", "Node memory capacity",
            ("node_id",)).set_default_tags({"node_id": nid})
        self._g_mm_threshold = metrics_mod.Gauge(
            "node_memory_monitor_threshold",
            "Memory-usage fraction above which the node kills a worker "
            "(RTPU_MEMORY_MONITOR_THRESHOLD; 0 = monitor disabled)",
            ("node_id",)).set_default_tags({"node_id": nid})
        self._g_worker_rss = metrics_mod.Gauge(
            "worker_rss_bytes", "Resident set size per live worker",
            ("node_id", "pid")).set_default_tags({"node_id": nid})
        self._lock = threading.Lock()
        self._history: deque = deque(maxlen=_HISTORY)
        self._latest: dict = {}
        self._prev_cpu = _read_cpu_times()
        self._prev_net = _read_net_bytes()
        self._prev_t = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sample()  # a snapshot is available immediately

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="node-stats-reporter", daemon=True)
        self._thread.start()

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def _loop(self):
        while not self._stop.wait(_SAMPLE_PERIOD_S):
            try:
                self.sample()
            except Exception:
                pass  # a bad /proc read must never kill the reporter

    def sample(self) -> dict:
        now = time.monotonic()
        busy, total = _read_cpu_times()
        pbusy, ptotal = self._prev_cpu
        dtotal = total - ptotal
        cpu_pct = 100.0 * (busy - pbusy) / dtotal if dtotal > 0 else 0.0
        self._prev_cpu = (busy, total)

        rx, tx = _read_net_bytes()
        dt = max(now - self._prev_t, 1e-6)
        rx_s = max(0, rx - self._prev_net[0]) / dt
        tx_s = max(0, tx - self._prev_net[1]) / dt
        self._prev_net = (rx, tx)
        self._prev_t = now

        mem_used, mem_total = node_memory_usage()
        try:
            st = os.statvfs("/")
            disk = {"total": st.f_blocks * st.f_frsize,
                    "free": st.f_bavail * st.f_frsize}
        except OSError:
            disk = {"total": 0, "free": 0}

        workers = []
        try:
            for pid, desc in self._workers_fn():
                workers.append({"pid": pid, "rss": process_rss(pid),
                                "comm": _proc_cmd_name(pid),
                                "task": desc})
        except Exception:
            pass

        self._g_mem_used.set(float(mem_used))
        self._g_mem_total.set(float(mem_total))
        self._g_mm_threshold.set(float(self._mm_threshold))
        # reset-then-set: exited workers' series must not linger
        self._g_worker_rss.clear()
        for w in workers:
            self._g_worker_rss.set(float(w["rss"]), {"pid": str(w["pid"])})

        snap = {
            "node_id": self._node_id.hex(),
            "ts": time.time(),
            "cpu_percent": round(cpu_pct, 1),
            "mem_used": mem_used,
            "mem_total": mem_total,
            "disk": disk,
            "net_rx_bytes_per_s": int(rx_s),
            "net_tx_bytes_per_s": int(tx_s),
            "workers": workers,
        }
        with self._lock:
            self._latest = snap
            self._history.append((snap["ts"], snap["cpu_percent"],
                                  mem_used, int(rx_s), int(tx_s)))
        return snap

    def latest(self) -> dict:
        with self._lock:
            out = dict(self._latest)
            out["history"] = [
                {"ts": t, "cpu_percent": c, "mem_used": m,
                 "net_rx_bytes_per_s": r, "net_tx_bytes_per_s": x}
                for t, c, m, r, x in self._history]
        return out
