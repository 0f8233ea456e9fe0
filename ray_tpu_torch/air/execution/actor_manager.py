"""Event-driven actor lifecycle management for experiment controllers.

Counterpart of ``ray_tpu/air/execution/actor_manager.py``; that is, of
the reference's ``RayActorManager``
(Ray's python/ray/air/execution/_internal/actor_manager.py:22):
a controller (Tune's trial loop; Train controllers could ride it too)
registers actors and method calls with callbacks; ``wait`` processes
whatever completed — actor task results route to their ``on_result``,
failures to ``on_error``, and an actor whose task dies with
``ActorDiedError`` is marked dead and reported via its ``on_actor_dead``
hook.  The controller never blocks on one specific actor, so one slow
trial cannot stall the event loop.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import ActorDiedError, RayTpuError


@dataclass
class TrackedActor:
    actor_id: int
    handle: Any = None
    state: str = "ALIVE"  # ALIVE | DEAD | STOPPED
    on_actor_dead: Optional[Callable[["TrackedActor", str], None]] = None
    data: Any = None  # controller payload (e.g. the Trial)
    in_flight: int = 0

    def __hash__(self):
        return self.actor_id


@dataclass
class _PendingTask:
    tracked: TrackedActor
    on_result: Optional[Callable]
    on_error: Optional[Callable]


class ActorManager:
    """Tracks actors + routes their task completions to callbacks."""

    def __init__(self):
        self._ids = itertools.count()
        self._actors: List[TrackedActor] = []
        self._pending: Dict[Any, _PendingTask] = {}  # ObjectRef -> meta

    # -- actors ------------------------------------------------------------

    def add_actor(self, actor_cls, *, options: Optional[dict] = None,
                  init_args: tuple = (), init_kwargs: Optional[dict] = None,
                  on_actor_dead: Optional[Callable] = None,
                  data: Any = None) -> TrackedActor:
        """Create and track an actor.  ``actor_cls`` is a plain class (it
        is wrapped with ``ray_tpu_torch.remote``) or an existing remote
        class."""
        remote_cls = (actor_cls if hasattr(actor_cls, "remote")
                      else ray_tpu_torch.remote(actor_cls))
        if options:
            remote_cls = remote_cls.options(**options)
        handle = remote_cls.remote(*init_args, **(init_kwargs or {}))
        tracked = TrackedActor(actor_id=next(self._ids), handle=handle,
                               on_actor_dead=on_actor_dead, data=data)
        self._actors.append(tracked)
        return tracked

    def remove_actor(self, tracked: TrackedActor, kill: bool = True) -> None:
        """Stop tracking (and by default kill) an actor.  Pending tasks on
        it are dropped without callbacks — the controller decided."""
        if tracked.state == "ALIVE":
            tracked.state = "STOPPED"
        for ref in [r for r, p in self._pending.items()
                    if p.tracked is tracked]:
            del self._pending[ref]
        tracked.in_flight = 0
        if kill and tracked.handle is not None:
            try:
                ray_tpu_torch.kill(tracked.handle)
            except Exception:
                pass
        tracked.handle = None
        if tracked in self._actors:
            self._actors.remove(tracked)

    @property
    def live_actors(self) -> List[TrackedActor]:
        return [a for a in self._actors if a.state == "ALIVE"]

    def num_pending_tasks(self, tracked: Optional[TrackedActor] = None) -> int:
        if tracked is None:
            return len(self._pending)
        return tracked.in_flight

    # -- tasks -------------------------------------------------------------

    def schedule_actor_task(self, tracked: TrackedActor, method: str,
                            args: tuple = (), kwargs: Optional[dict] = None,
                            on_result: Optional[Callable] = None,
                            on_error: Optional[Callable] = None) -> bool:
        """Submit ``handle.method(*args)``; completion routes to the
        callbacks at the next ``wait``.  False if the actor is gone."""
        if tracked.state != "ALIVE" or tracked.handle is None:
            return False
        ref = getattr(tracked.handle, method).remote(
            *args, **(kwargs or {}))
        self._pending[ref] = _PendingTask(tracked, on_result, on_error)
        tracked.in_flight += 1
        return True

    def wait(self, timeout: Optional[float] = 0.05,
             max_events: int = 64) -> int:
        """Process up to ``max_events`` completed tasks; returns how many
        fired.  Callbacks run on the calling thread (the controller's
        event loop — reference semantics: RayActorManager.next)."""
        if not self._pending:
            # nothing in flight: honor the timeout anyway so controller
            # loops built on wait() never busy-spin
            if timeout:
                time.sleep(timeout)
            return 0
        refs = list(self._pending.keys())
        ready, _ = ray_tpu_torch.wait(
            refs, num_returns=min(max_events, len(refs)), timeout=timeout)
        fired = 0
        for ref in ready:
            meta = self._pending.pop(ref, None)
            if meta is None:
                continue
            meta.tracked.in_flight = max(0, meta.tracked.in_flight - 1)
            try:
                value = ray_tpu_torch.get(ref)
            except RayTpuError as e:
                self._on_task_error(meta, e)
                fired += 1
                continue
            except Exception as e:  # user exception from the method
                self._on_task_error(meta, e)
                fired += 1
                continue
            if meta.on_result is not None:
                meta.on_result(meta.tracked, value)
            fired += 1
        return fired

    def _on_task_error(self, meta: _PendingTask, exc: BaseException) -> None:
        tracked = meta.tracked
        if isinstance(exc, ActorDiedError) and tracked.state == "ALIVE":
            tracked.state = "DEAD"
            # drop other pending tasks on the dead actor: each would raise
            # the same death; one notification is the contract
            for ref in [r for r, p in self._pending.items()
                        if p.tracked is tracked]:
                del self._pending[ref]
            tracked.in_flight = 0
            if tracked.on_actor_dead is not None:
                tracked.on_actor_dead(tracked, str(exc))
                return
        if meta.on_error is not None:
            meta.on_error(tracked, exc)
