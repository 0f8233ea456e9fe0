"""streaming_split: one execution shared by n consumer shards.

Counterpart of ``ray_tpu/data/split.py`` (Ray's StreamSplitDataIterator +
OutputSplitter, python/ray/data/_internal/execution/operators/
output_splitter.py): a coordinator actor runs the plan on a background
thread and deals output bundles round-robin into per-shard queues of
bounded depth (a slow shard stalls only its own queue, and eventually the
shared executor).  Train workers each pull their shard.

The plan reaches the coordinator through the store: a ``from_items``
plan holds its rows, and the native transport drops a new worker that
reads nothing for 10 s while it imports torch, so a plan sent inline in
the constructor's call could kill the coordinator.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterable, List

import cloudpickle

import ray_tpu_torch as rt

_DONE = "__done__"
_ERR = "__err__"


class SplitCoordinator:
    """Actor: executes the plan once, feeds n shard queues.  ``plan_blob``
    is the cloudpickled logical plan."""

    def __init__(self, plan_blob: bytes, n: int,
                 max_queued_per_shard: int = 8):
        self._plan = cloudpickle.loads(plan_blob)
        self._n = n
        self._queues: List[queue_mod.Queue] = [
            queue_mod.Queue(maxsize=max_queued_per_shard) for _ in range(n)]
        self._started = False
        self._error: str = ""

    def start(self) -> str:
        if self._started:
            return "ok"
        self._started = True

        def feed():
            try:
                from ray_tpu_torch.data.executor import execute_streaming

                i = 0
                for bundle in execute_streaming(self._plan):
                    for pair in bundle:
                        self._queues[i % self._n].put(pair)
                        i += 1
                for q in self._queues:
                    q.put(_DONE)
            except BaseException as e:  # noqa: BLE001
                # Record the error out-of-band (a full shard queue must not
                # block the broadcast), then nudge each queue best-effort.
                self._error = repr(e)
                for q in self._queues:
                    try:
                        q.put_nowait((_ERR, self._error))
                    except queue_mod.Full:
                        pass

        threading.Thread(target=feed, daemon=True).start()
        return "ok"

    def get_next(self, shard: int):
        """Blocking pop; returns (ref, meta) or the _DONE sentinel.  Runs on
        the actor's thread pool (max_concurrency > n) so shards can block
        concurrently."""
        while True:
            try:
                item = self._queues[shard].get(timeout=0.5)
            except queue_mod.Empty:
                if self._error:
                    raise RuntimeError(
                        f"streaming_split execution failed: {self._error}")
                continue
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] == _ERR):
                raise RuntimeError(
                    f"streaming_split execution failed: {item[1]}")
            return item


class ShardIterable:
    """Iterable over one shard's bundles; handed to a DataIterator."""

    def __init__(self, coordinator, shard: int):
        self._coord = coordinator
        self._shard = shard

    def __iter__(self):
        while True:
            item = rt.get(self._coord.get_next.remote(self._shard))
            if item == _DONE:
                return
            yield item


def kill_coordinators(shards: Iterable) -> int:
    """Kill the split coordinators behind ``shards`` (DataIterators, or
    dicts or lists of them, as a trainer's per-rank shards are); returns
    how many.  A trainer's attempt re-splits its datasets, so the last
    attempt's coordinators end with it."""
    from ray_tpu_torch.data.iterator import DataIterator

    coords = {}
    stack = list(shards)
    while stack:
        item = stack.pop()
        if isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
        elif isinstance(item, DataIterator) and isinstance(
                item._bundles, ShardIterable):
            coord = item._bundles._coord
            coords[coord.actor_id] = coord
    for coord in coords.values():
        try:
            rt.kill(coord)
        except Exception:
            pass
    return len(coords)
