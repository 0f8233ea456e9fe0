"""DAG node model: lazy graphs of actor-method calls.

Counterpart of the reference DAG API
(Ray's python/ray/dag/dag_node.py, input_node.py,
class_node.py): ``actor.method.bind(...)`` builds ``ClassMethodNode``s over
``InputNode``; ``dag.execute(x)`` runs eagerly through normal task
submission; ``dag.experimental_compile()`` lowers the graph onto
pre-allocated shm channels + resident per-actor execution loops
(ray_tpu_torch.dag.compiled).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """Base: a lazily-evaluated node. Subclasses define _eval."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs)

    # -- traversal ---------------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out = [a for a in self._bound_args if isinstance(a, DAGNode)]
        out += [v for v in self._bound_kwargs.values()
                if isinstance(v, DAGNode)]
        return out

    def topo_sort(self) -> List["DAGNode"]:
        order, seen = [], set()

        def visit(n: DAGNode):
            if id(n) in seen:
                return
            seen.add(id(n))
            for c in n._children():
                visit(c)
            order.append(n)

        visit(self)
        return order

    # -- eager execution ---------------------------------------------------
    def execute(self, *input_vals, _memo: Optional[dict] = None):
        """Run the DAG through normal task submission; returns ObjectRef(s)."""
        memo: dict = {} if _memo is None else _memo
        input_val = input_vals[0] if input_vals else None
        return _eval(self, input_val, memo)

    def experimental_compile(self, buffer_size: int = 16,
                             submit_timeout: Optional[float] = None):
        from ray_tpu_torch.dag.compiled import CompiledDAG
        return CompiledDAG(self, buffer_size=buffer_size)


def _eval(node, input_val, memo):
    if not isinstance(node, DAGNode):
        return node
    if id(node) in memo:
        return memo[id(node)]
    result = node._eval(input_val, memo)
    memo[id(node)] = result
    return result


class InputNode(DAGNode):
    """The DAG's runtime input. Context-manager use mirrors the reference:

        with InputNode() as inp:
            dag = a.f.bind(inp)
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getitem__(self, key):
        return InputAttributeNode(self, key)

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        return InputAttributeNode(self, key)

    def _eval(self, input_val, memo):
        return input_val


class InputAttributeNode(DAGNode):
    """inp[key] / inp.key — one field of a dict/sequence input."""

    def __init__(self, parent: InputNode, key):
        super().__init__((parent,), {})
        self._key = key

    def _eval(self, input_val, memo):
        base = _eval(self._bound_args[0], input_val, memo)
        if isinstance(self._key, str) and not isinstance(base, dict):
            return getattr(base, self._key)
        return base[self._key]


class ClassMethodNode(DAGNode):
    """actor.method.bind(*args, **kwargs)."""

    def __init__(self, actor_handle, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._actor = actor_handle
        self._method_name = method_name

    def _eval(self, input_val, memo):
        args = [_eval(a, input_val, memo) for a in self._bound_args]
        kwargs = {k: _eval(v, input_val, memo)
                  for k, v in self._bound_kwargs.items()}
        method = getattr(self._actor, self._method_name)
        return method.remote(*args, **kwargs)

    def __repr__(self):
        return (f"ClassMethodNode({self._actor._class_name}."
                f"{self._method_name})")


class MultiOutputNode(DAGNode):
    """Bundle several leaves into one DAG output (list of results)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _eval(self, input_val, memo):
        return [_eval(a, input_val, memo) for a in self._bound_args]
