"""ActorPool: operate on a fixed pool of actors.

Counterpart of Ray's python/ray/util/actor_pool.py:13 — same
surface (map, map_unordered, submit, get_next, get_next_unordered,
has_next, has_free, pop_idle, push).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle_actors = list(actors)
        self._future_to_actor: dict = {}  # ref -> (index, actor)
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: list = []
        # indices consumed out-of-order by get_next_unordered, so the
        # ordered getter can skip them instead of waiting forever
        self._consumed: set = set()

    def map(self, fn: Callable, values: Iterable) -> Iterator:
        """Apply fn(actor, value) over values; yield results IN ORDER."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable) -> Iterator:
        """Like map, but yields results as they complete."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def submit(self, fn: Callable, value: Any):
        """Schedule fn(actor, value) on an idle actor (or queue it)."""
        if self._idle_actors:
            actor = self._idle_actors.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending_submits)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in SUBMISSION order."""
        # skip indices already consumed by get_next_unordered
        while self._next_return_index in self._consumed:
            self._consumed.discard(self._next_return_index)
            self._next_return_index += 1
        if not self.has_next():
            raise StopIteration("no more results to get")
        index = self._next_return_index
        # the future may not exist yet (task still queued behind busy actors)
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        while index not in self._index_to_future:
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError("timed out waiting for result")
            self._drain_one(remaining(deadline))
        future = self._index_to_future.pop(index)
        self._next_return_index += 1
        # return the actor BEFORE get: a task that raised must not leave
        # its actor marked busy forever (reference does the same)
        actor = self._future_to_actor.pop(future)[1]
        self._return_actor(actor)
        return ray_tpu_torch.get(future, timeout=remaining(deadline))

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next result in COMPLETION order."""
        if not self.has_next():
            raise StopIteration("no more results to get")
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._future_to_actor:
            self._flush_pending()
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                num_returns=1,
                                timeout=remaining(deadline))
        if not ready:
            raise TimeoutError("timed out waiting for result")
        future = ready[0]
        index, actor = self._future_to_actor.pop(future)
        self._index_to_future.pop(index, None)
        # keep ordered bookkeeping consistent for later get_next calls
        if index == self._next_return_index:
            self._next_return_index += 1
        else:
            self._consumed.add(index)
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    def has_free(self) -> bool:
        return bool(self._idle_actors) and not self._pending_submits

    def pop_idle(self) -> Optional[Any]:
        if self.has_free():
            return self._idle_actors.pop()
        return None

    def push(self, actor: Any):
        busy = {a for _, a in self._future_to_actor.values()}
        if actor in self._idle_actors or actor in busy:
            raise ValueError("actor already belongs to this pool")
        self._return_actor(actor)

    # -- internals ---------------------------------------------------------
    def _return_actor(self, actor):
        self._idle_actors.append(actor)
        self._flush_pending()

    def _flush_pending(self):
        while self._pending_submits and self._idle_actors:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def _drain_one(self, timeout):
        """Wait for ANY in-flight future so a busy actor frees up."""
        self._flush_pending()
        if not self._future_to_actor:
            return
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                num_returns=1, timeout=timeout)


def remaining(deadline):
    if deadline is None:
        return None
    import time

    return max(0.0, deadline - time.monotonic())
