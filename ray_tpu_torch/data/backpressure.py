"""Pluggable backpressure policies for the streaming executor.

Counterpart of ``ray_tpu/data/backpressure.py`` (Ray's backpressure
policy plugins, python/ray/data/_internal/execution/backpressure_policy/:
ConcurrencyCapBackpressurePolicy, StreamingOutputBackpressurePolicy).  The
pull-based generator executor gives coarse backpressure for free (an op
launches at most ``window`` tasks and only refills when downstream
consumes); policies refine WHEN the window may refill:

- ``ConcurrencyCapPolicy``: the classic in-flight task cap (the default).
- ``OutputBytesPolicy``: bound the estimated bytes of unconsumed output an
  op may hold in the object store — ops producing huge blocks throttle
  below their concurrency cap so the store isn't flooded (Ray's
  streaming-output policy plays this role).

Custom policies subclass ``BackpressurePolicy`` and are installed on the
``DataContext``::

    ctx = DataContext.get_current()
    ctx.backpressure_policies = [MyPolicy(), ConcurrencyCapPolicy()]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class OpSnapshot:
    """What a policy sees before each launch decision."""

    op_name: str
    in_flight: int            # tasks currently running
    window: int               # the op's configured concurrency cap
    bytes_per_task: float     # rolling estimate of output bytes per task
    outstanding_bytes: float  # estimated unconsumed output in the store
    # unique per OPERATOR EXECUTION: two concurrent ops can share a
    # display name ("Map(<lambda>)"), and identity-keyed accounting must
    # not alias them
    op_token: str = ""


class BackpressurePolicy:
    """Decide whether an operator may launch one more task.

    ``on_launch``/``on_complete`` let stateful policies account across
    operators (a policy instance installed on the DataContext is SHARED
    by every op in the process — that sharing is what makes a global
    resource manager possible)."""

    def can_launch(self, snap: OpSnapshot) -> bool:
        raise NotImplementedError

    def on_launch(self, snap: OpSnapshot) -> None:
        pass

    def on_complete(self, op_token: str, out_bytes: int) -> None:
        """op_token is the UNIQUE execution token (OpSnapshot.op_token),
        matching on_launch's snap.op_token — not the display name."""
        pass


class ConcurrencyCapPolicy(BackpressurePolicy):
    """At most ``window`` tasks in flight (Ray:
    ConcurrencyCapBackpressurePolicy)."""

    def can_launch(self, snap: OpSnapshot) -> bool:
        return snap.in_flight < snap.window


class OutputBytesPolicy(BackpressurePolicy):
    """Bound estimated unconsumed output bytes per op (Ray:
    StreamingOutputBackpressurePolicy).  Always admits the first task —
    the estimate needs one completed task to calibrate."""

    def __init__(self, max_outstanding_bytes: int = 512 * 1024 * 1024):
        self.max_outstanding_bytes = max_outstanding_bytes

    def can_launch(self, snap: OpSnapshot) -> bool:
        if snap.in_flight == 0:
            return True
        if snap.bytes_per_task <= 0:
            # uncalibrated (no task has completed): hold concurrency low
            # instead of flooding the window before the first estimate
            return snap.in_flight < 2
        return snap.outstanding_bytes < self.max_outstanding_bytes


class ResourceManagerPolicy(BackpressurePolicy):
    """Execution-wide task budget across ALL operators (Ray:
    _internal/execution/resource_manager.py — the streaming executor's
    per-op resource bookkeeping feeding global limits).  A pipeline of N
    ops each honoring its own window can still oversubscribe the cluster
    N-fold; this policy caps their SUM."""

    def __init__(self, max_total_tasks: Optional[int] = None):
        import os as _os
        import threading as _threading

        self.max_total_tasks = max_total_tasks or max(
            8, 2 * (_os.cpu_count() or 4))
        self._lock = _threading.Lock()
        self._in_flight: dict = {}

    def total_in_flight(self) -> int:
        with self._lock:
            return sum(self._in_flight.values())

    def can_launch(self, snap: OpSnapshot) -> bool:
        with self._lock:
            other = sum(v for k, v in self._in_flight.items()
                        if k != snap.op_token)
        # this op's own count comes from the snapshot (authoritative)
        return other + snap.in_flight < self.max_total_tasks

    def on_launch(self, snap: OpSnapshot) -> None:
        with self._lock:
            self._in_flight[snap.op_token] = \
                self._in_flight.get(snap.op_token, 0) + 1

    def on_complete(self, op_token: str, out_bytes: int) -> None:
        with self._lock:
            n = self._in_flight.get(op_token, 0) - 1
            if n > 0:
                self._in_flight[op_token] = n
            else:
                self._in_flight.pop(op_token, None)


def default_policies() -> list:
    return [ConcurrencyCapPolicy(), OutputBytesPolicy()]
