"""multiprocessing.Pool clone on the actor runtime.

Counterpart of Ray's python/ray/util/multiprocessing/pool.py:545
(``Pool``): the standard-library Pool surface (apply/apply_async, map/
map_async, starmap, imap/imap_unordered, with chunking) executed by a pool
of actors instead of forked processes.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool


class _PoolActor:
    def __init__(self, initializer=None, initargs=None):
        if initializer is not None:
            initializer(*(initargs or ()))

    def run_chunk(self, func, chunk, star: bool):
        if star:
            return [func(*args) for args in chunk]
        return [func(args) for args in chunk]


class AsyncResult:
    def __init__(self, refs: List[Any], single: bool = False):
        self._refs = refs
        self._single = single

    def wait(self, timeout: Optional[float] = None):
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=timeout)

    def get(self, timeout: Optional[float] = None):
        chunks = ray_tpu_torch.get(self._refs, timeout=timeout)
        flat = [v for chunk in chunks for v in chunk]
        return flat[0] if self._single else flat

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            ray_tpu_torch.get(self._refs, timeout=0)
            return True
        except Exception:
            return False


class Pool:
    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = (),
                 maxtasksperchild: Optional[int] = None,
                 ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        if processes is None:
            processes = max(1, int(
                ray_tpu_torch.cluster_resources().get("CPU", 1)))
        self._processes = processes
        opts = dict(ray_remote_args or {})
        cls = ray_tpu_torch.remote(_PoolActor)
        self._actors = [cls.options(**opts).remote(initializer, initargs)
                        for _ in range(processes)]
        self._closed = False
        self._lock = threading.Lock()
        self._apply_rr = 0  # round-robin cursor for apply_async

    def _check_running(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, -(-len(items) // (self._processes * 4)))
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)], chunksize

    # -- apply -------------------------------------------------------------
    def apply(self, func, args: tuple = (), kwds: Optional[dict] = None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func, args: tuple = (),
                    kwds: Optional[dict] = None):
        self._check_running()
        kwds = kwds or {}
        with self._lock:
            actor = self._actors[self._apply_rr % self._processes]
            self._apply_rr += 1
        ref = actor.run_chunk.remote(
            lambda a: func(*a[0], **a[1]), [(args, kwds)], False)
        return AsyncResult([ref], single=True)

    # -- map ---------------------------------------------------------------
    def map(self, func, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        self._check_running()
        chunks, _ = self._chunks(iterable, chunksize)
        refs = [self._actors[i % self._processes].run_chunk.remote(
            func, chunk, False) for i, chunk in enumerate(chunks)]
        return AsyncResult(refs)

    def starmap(self, func, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        return self.starmap_async(func, iterable, chunksize).get()

    def starmap_async(self, func, iterable: Iterable,
                      chunksize: Optional[int] = None) -> AsyncResult:
        self._check_running()
        chunks, _ = self._chunks(iterable, chunksize)
        refs = [self._actors[i % self._processes].run_chunk.remote(
            func, chunk, True) for i, chunk in enumerate(chunks)]
        return AsyncResult(refs)

    # -- imap --------------------------------------------------------------
    def imap(self, func, iterable: Iterable,
             chunksize: Optional[int] = None):
        self._check_running()
        pool = ActorPool(self._actors)
        chunks, _ = self._chunks(iterable, chunksize)
        for value in pool.map(
                lambda a, chunk: a.run_chunk.remote(func, chunk, False),
                chunks):
            yield from value

    def imap_unordered(self, func, iterable: Iterable,
                       chunksize: Optional[int] = None):
        self._check_running()
        pool = ActorPool(self._actors)
        chunks, _ = self._chunks(iterable, chunksize)
        for value in pool.map_unordered(
                lambda a, chunk: a.run_chunk.remote(func, chunk, False),
                chunks):
            yield from value

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        self._check_running()
        return self

    def __exit__(self, *exc):
        self.terminate()
