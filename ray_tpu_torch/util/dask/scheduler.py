"""The Dask-on-Ray scheduler.

Counterpart of ``ray_tpu/util/dask/scheduler.py``.  The dask graph spec
(https://docs.dask.org/en/stable/spec.html, and the shapes consumed by
Ray's python/ray/util/dask/scheduler_utils.py):

  * a graph is a dict ``key -> computation``
  * a *task* is a tuple whose first element is callable
  * any hashable value that is itself a key of the graph is a reference to
    that key's result (including inside nested lists/tuples/dicts)
  * anything else is a literal

Each task becomes one task of the port's runtime.  Dependencies are
flattened to TOP-LEVEL ObjectRef arguments (the worker resolves only
top-level refs; the same constraint as Ray's, whose ``dask_task_wrapper``
in python/ray/util/dask/scheduler.py repacks position-indexed refs) and
substituted again inside the expression by placeholder index before
evaluation.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List

import ray_tpu_torch


class _Placeholder:
    """Marks a dependency slot inside a task expression; ``i`` indexes the
    flat ref list submitted as top-level args."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __reduce__(self):
        return (_Placeholder, (self.i,))


def _is_task(v: Any) -> bool:
    return isinstance(v, tuple) and len(v) > 0 and callable(v[0])


def _is_key(v: Any, dsk: dict) -> bool:
    if _is_task(v):
        return False
    try:
        return v in dsk
    except TypeError:  # unhashable → literal
        return False


def _toposort(dsk: dict) -> List[Hashable]:
    """DFS topological order with cycle detection."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[Hashable, int] = {k: WHITE for k in dsk}
    out: List[Hashable] = []

    def deps_of(expr, acc):
        if _is_key(expr, dsk):
            acc.append(expr)
        elif _is_task(expr):
            for a in expr[1:]:
                deps_of(a, acc)
        elif isinstance(expr, (list, tuple)):
            for a in expr:
                deps_of(a, acc)
        elif isinstance(expr, dict):
            for a in expr.values():
                deps_of(a, acc)
        return acc

    for start in dsk:
        if color[start] != WHITE:
            continue
        stack = [(start, iter(deps_of(dsk[start], [])))]
        color[start] = GRAY
        while stack:
            node, it = stack[-1]
            advanced = False
            for dep in it:
                if color[dep] == GRAY:
                    raise ValueError(f"cycle in dask graph at {dep!r}")
                if color[dep] == WHITE:
                    color[dep] = GRAY
                    stack.append((dep, iter(deps_of(dsk[dep], []))))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                out.append(node)
                stack.pop()
    return out


def _substitute(expr: Any, dsk: dict, refs: dict, flat: list) -> Any:
    """Replace key references with placeholders, collecting their refs."""
    if _is_key(expr, dsk):
        flat.append(refs[expr])
        return _Placeholder(len(flat) - 1)
    if _is_task(expr):
        return tuple([expr[0]] + [_substitute(a, dsk, refs, flat)
                                  for a in expr[1:]])
    if isinstance(expr, list):
        return [_substitute(a, dsk, refs, flat) for a in expr]
    if isinstance(expr, tuple):
        return tuple(_substitute(a, dsk, refs, flat) for a in expr)
    if isinstance(expr, dict):
        return {k: _substitute(v, dsk, refs, flat)
                for k, v in expr.items()}
    return expr


def _evaluate(expr: Any, resolved: tuple) -> Any:
    if isinstance(expr, _Placeholder):
        return resolved[expr.i]
    if _is_task(expr):
        return expr[0](*[_evaluate(a, resolved) for a in expr[1:]])
    if isinstance(expr, list):
        return [_evaluate(a, resolved) for a in expr]
    if isinstance(expr, tuple):
        return tuple(_evaluate(a, resolved) for a in expr)
    if isinstance(expr, dict):
        return {k: _evaluate(v, resolved) for k, v in expr.items()}
    return expr


@ray_tpu_torch.remote
def _dask_exec(expr, *resolved):
    """One dask graph task: resolved holds the (already-materialized)
    dependency values in _Placeholder order."""
    return _evaluate(expr, resolved)


def ray_dask_get(dsk: dict, keys, **kwargs):
    """A dask ``get``: compute ``keys`` (a key or arbitrarily nested lists
    of keys) from graph ``dsk`` on the port's cluster.

    Extra kwargs (dask passes e.g. ``num_workers``) are accepted and
    ignored — parallelism comes from the cluster scheduler.
    """
    refs: Dict[Hashable, Any] = {}
    for key in _toposort(dsk):
        expr = dsk[key]
        if _is_key(expr, dsk):          # alias: key -> other key
            refs[key] = refs[expr]
            continue
        flat: list = []
        sub = _substitute(expr, dsk, refs, flat)
        if not _is_task(expr) and not flat:
            refs[key] = ray_tpu_torch.put(expr)  # literal
            continue
        refs[key] = _dask_exec.options(
            name=f"dask:{str(key)[:40]}").remote(sub, *flat)

    def pack(ks):
        if isinstance(ks, list):
            return [pack(k) for k in ks]
        return ray_tpu_torch.get(refs[ks])

    return pack(keys)


_saved_config: list = []


def enable_dask_on_ray():
    """Register ray_dask_get as dask's default scheduler (requires dask)."""
    try:
        import dask
    except ImportError as e:
        raise ImportError(
            "enable_dask_on_ray() needs the `dask` package; "
            "ray_dask_get(dsk, keys) works on raw graphs without it"
        ) from e
    _saved_config.append(dask.config.get("scheduler", None))
    dask.config.set(scheduler=ray_dask_get)


def disable_dask_on_ray():
    import dask

    prev = _saved_config.pop() if _saved_config else None
    dask.config.set(scheduler=prev)
