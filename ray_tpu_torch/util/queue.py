"""Distributed Queue backed by an actor.

Counterpart of Ray's python/ray/util/queue.py:21 — same surface
(put/get with block+timeout, *_nowait, *_nowait_batch, qsize/empty/full,
shutdown).  The actor runs with max_concurrency so blocked getters don't
starve puts (the reference uses an asyncio actor for the same reason).
"""

from __future__ import annotations

import queue as _queue
from typing import Any, Iterable, List, Optional

import ray_tpu_torch


class Empty(_queue.Empty):
    pass


class Full(_queue.Full):
    pass


class _QueueActor:
    """All methods are NON-blocking: a blocking wait inside the actor would
    pin one of its max_concurrency threads, and enough blocked getters
    would starve the puts that could wake them (permanent deadlock).  The
    CLIENT polls instead — the reference avoids the same hazard with an
    asyncio actor."""

    def __init__(self, maxsize: int):
        self._q: _queue.Queue = _queue.Queue(maxsize=maxsize)

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()

    def put(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except _queue.Full:
            return False

    def put_batch(self, items: list) -> bool:
        if (self._q.maxsize > 0
                and self._q.qsize() + len(items) > self._q.maxsize):
            return False
        for item in items:
            self._q.put_nowait(item)
        return True

    def get(self):
        try:
            return True, self._q.get_nowait()
        except _queue.Empty:
            return False, None

    def get_batch(self, num_items: int):
        if self._q.qsize() < num_items:
            return False, None
        return True, [self._q.get_nowait() for _ in range(num_items)]


class Queue:
    def __init__(self, maxsize: int = 0,
                 actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 8)
        self.actor = ray_tpu_torch.remote(_QueueActor).options(**opts).remote(
            maxsize)

    def __len__(self) -> int:
        return self.size()

    def size(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def qsize(self) -> int:
        return self.size()

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None):
        if timeout is not None and timeout < 0:
            raise ValueError("'timeout' must be a non-negative number")
        import time

        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            if ray_tpu_torch.get(self.actor.put.remote(item)):
                return
            if not block or (deadline is not None
                             and time.monotonic() >= deadline):
                raise Full
            time.sleep(0.01)

    def put_nowait(self, item: Any):
        self.put(item, block=False)

    def put_nowait_batch(self, items: Iterable):
        items = list(items)
        if not ray_tpu_torch.get(self.actor.put_batch.remote(items)):
            raise Full(f"Cannot add {len(items)} items to queue of size "
                       f"{self.maxsize}")

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if timeout is not None and timeout < 0:
            raise ValueError("'timeout' must be a non-negative number")
        import time

        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get.remote())
            if ok:
                return item
            if not block or (deadline is not None
                             and time.monotonic() >= deadline):
                raise Empty
            time.sleep(0.01)

    def get_nowait(self):
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        ok, items = ray_tpu_torch.get(self.actor.get_batch.remote(num_items))
        if not ok:
            raise Empty(f"Cannot get {num_items} items from queue of size "
                        f"{self.size()}")
        return items

    def shutdown(self, force: bool = False, grace_period_s: int = 5):
        if self.actor is not None:
            ray_tpu_torch.kill(self.actor)
        self.actor = None
