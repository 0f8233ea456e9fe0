"""The port's stand-in for the runtime's actors: ``remote``, ``get``,
``wait``, ``put`` and ``kill``.

The JAX package runs its env runners as ``ray_tpu`` actors.  The port has
no runtime yet, so each actor here is an object living on a thread of its
own: one single-thread executor per actor runs its constructor and then
its method calls in the order they were made, as an actor's mailbox does.
A ``concurrent.futures.Future`` takes the place of an ObjectRef, so the
learner overlaps sampling exactly where the JAX algorithms do (APPO's
pipelined batch, IMPALA's requests in flight).  Runner threads compute on
CPU tensors only; the learner alone launches device work.
"""

from __future__ import annotations

from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import wait as _wait
from typing import Any, List, Optional, Sequence, Tuple


def _resolve(value):
    """A Future passed as an argument stands for its value, as an ObjectRef
    passed to an actor method does."""
    return value.result() if isinstance(value, Future) else value


class _Method:
    def __init__(self, actor: "ActorHandle", name: str):
        self._actor, self._name = actor, name

    def remote(self, *args, **kwargs) -> Future:
        actor, name = self._actor, self._name

        def call():
            instance = actor._instance.result()
            return getattr(instance, name)(
                *map(_resolve, args),
                **{k: _resolve(v) for k, v in kwargs.items()})

        return actor._executor.submit(call)


class ActorHandle:
    """An instance of ``cls`` built and called on its own thread."""

    def __init__(self, cls, args, kwargs):
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"actor-{cls.__name__}")
        self._instance = self._executor.submit(cls, *args, **kwargs)

    def __getattr__(self, name: str) -> _Method:
        if name.startswith("_"):
            raise AttributeError(name)
        return _Method(self, name)


class ActorClass:
    def __init__(self, cls):
        self._cls = cls

    def remote(self, *args, **kwargs) -> ActorHandle:
        return ActorHandle(self._cls, args, kwargs)


def remote(cls) -> ActorClass:
    """``ray_tpu.remote`` for a class: ``remote(C).remote(...)`` makes an
    actor whose ``.method.remote(...)`` returns a Future."""
    return ActorClass(cls)


def get(futures, timeout: Optional[float] = None):
    """The value of one Future, or the values of a list of them; raises the
    call's exception, or ``TimeoutError`` after ``timeout`` seconds."""
    if isinstance(futures, Future):
        return futures.result(timeout)
    return [f.result(timeout) for f in futures]


def wait(futures: Sequence[Future], num_returns: int = 1,
         timeout: Optional[float] = None) -> Tuple[List[Future],
                                                   List[Future]]:
    """(ready, not ready) once ``num_returns`` Futures are done or after
    ``timeout`` seconds, in the order given.  Only ``num_returns=1`` is
    supported, the one way the algorithms call it."""
    if num_returns != 1:
        raise NotImplementedError("wait supports num_returns=1")
    done, _ = _wait(futures, timeout=timeout, return_when=FIRST_COMPLETED)
    ready = [f for f in futures if f in done][:num_returns]
    return ready, [f for f in futures if f not in ready]


def put(value: Any) -> Future:
    """A done Future holding ``value`` (the caller hands in a snapshot it
    will not change)."""
    future: Future = Future()
    future.set_result(value)
    return future


def kill(actor: ActorHandle) -> None:
    """Drop the actor's queued calls and let its thread end after the call
    it is running."""
    actor._executor.shutdown(wait=False, cancel_futures=True)
