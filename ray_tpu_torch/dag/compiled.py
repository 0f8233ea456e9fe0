"""Compiled DAG execution: resident actor loops over shm channels.

Counterpart of the reference's CompiledDAG
(Ray's python/ray/dag/compiled_dag_node.py:808, ExecutableTask
:481): compilation pre-allocates one channel per data edge and starts a
background execution loop *inside* each participating actor (via the hidden
``__rtpu_apply__`` method), so steady-state execution moves data
driver→actors→driver purely through the shm channel plane — no per-call task
submission, no scheduler round-trips. This is the substrate pipeline
parallelism uses for cross-stage hand-off (SURVEY.md §2.4 PP row).

Error semantics: an exception in one stage flows downstream as an
``_ExcPayload`` and is raised at ``ref.get()``; the loops keep running, so a
bad input doesn't wedge the pipeline (teardown() stops everything).
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.dag.channel import STOP, Channel, ChannelClosed
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)


class _ExcPayload:
    def __init__(self, exc: BaseException, tb: str):
        self.exc = exc
        self.tb = tb


def _dag_actor_loop(instance, method_name: str,
                    arg_specs: List[Tuple[str, Any]],
                    kwarg_specs: Dict[str, Tuple[str, Any]],
                    out_channels: List[Channel]) -> None:
    """Runs inside the actor process: start the resident loop thread."""

    def loop():
        method = getattr(instance, method_name)
        while True:
            try:
                args, kwargs, poisoned = [], {}, None
                try:
                    for kind, v in arg_specs:
                        val = v.read() if kind == "chan" else v
                        if isinstance(val, _ExcPayload):
                            poisoned = val
                        args.append(val)
                    for k, (kind, v) in kwarg_specs.items():
                        val = v.read() if kind == "chan" else v
                        if isinstance(val, _ExcPayload):
                            poisoned = val
                        kwargs[k] = val
                except ChannelClosed:
                    for ch in out_channels:
                        try:
                            # bounded: a dead downstream with a full ring
                            # must not wedge this thread forever (cleanup
                            # below still has to run)
                            ch.write(STOP, timeout=5.0)
                        except Exception:
                            pass
                    # reader-side shm cleanup: the driver can only unlink
                    # segments on ITS host, so each loop reclaims its own
                    # node's in-edges (unlink keeps live mappings valid)
                    for kind, v in list(arg_specs) + list(
                            kwarg_specs.values()):
                        if kind == "chan":
                            v.unlink_native()
                    return
                if poisoned is not None:
                    result = poisoned  # propagate, don't execute
                else:
                    try:
                        result = method(*args, **kwargs)
                    except BaseException as e:  # noqa: BLE001
                        result = _ExcPayload(e, traceback.format_exc())
                for ch in out_channels:
                    ch.write(result)
            except BaseException:  # loop must survive transient store errors
                traceback.print_exc()
                return

    t = threading.Thread(target=loop, name=f"dag-loop-{method_name}",
                         daemon=True)
    t.start()
    loops = getattr(instance, "_rtpu_dag_loops", None)
    if loops is None:
        loops = []
        try:
            instance._rtpu_dag_loops = loops
        except Exception:
            pass
    loops.append(t)


def _dag_noop(_instance):
    return None


class CompiledDAGRef:
    """Result handle for one CompiledDAG.execute call."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: Optional[float] = None):
        return self._dag._fetch(self._seq, timeout)


class CompiledDAG:
    def __init__(self, root: DAGNode, buffer_size: int = 16):
        self._root = root
        self._buffer_size = buffer_size
        self._seq = 0
        self._results: Dict[int, Any] = {}
        self._next_read = 0
        self._torn_down = False
        self._lock = threading.Lock()
        self._compile()

    # -- compilation -------------------------------------------------------
    def _new_channel(self, writer_node, reader_node) -> Channel:
        # same-node edges ride the native mutable shm ring; cross-node (or
        # unknown, e.g. client-mode driver) edges use the store transport
        native = (writer_node is not None and writer_node == reader_node)
        return Channel(os.urandom(16), capacity=self._buffer_size,
                       native=native)

    def _compile(self):
        order = self._root.topo_sort()

        # Resolve actor placement first (channel transport selection):
        # one no-op round also guarantees every actor finished creation.
        from ray_tpu_torch import api
        from ray_tpu_torch._private.worker import global_worker

        actor_handles = {}
        for n in order:
            if isinstance(n, ClassMethodNode):
                actor_handles[n._actor.actor_id] = n._actor
        actor_node: dict = {}
        if actor_handles:
            api.get([a.__rtpu_apply__.remote(_dag_noop)
                     for a in actor_handles.values()])
            for row in global_worker().rpc("list_actors", {}):
                actor_node[row["actor_id"]] = row["node_id"]
        drv = getattr(global_worker(), "node", None)
        driver_node = drv.node_id if drv is not None else None
        self._input_node = None
        for n in order:
            if isinstance(n, InputNode):
                if self._input_node is not None and n is not self._input_node:
                    raise ValueError("a DAG can have only one InputNode")
                self._input_node = n

        # Output leaves: MultiOutputNode's children, else the root itself.
        if isinstance(self._root, MultiOutputNode):
            leaves = list(self._root._bound_args)
            self._multi_output = True
        else:
            leaves = [self._root]
            self._multi_output = False
        for leaf in leaves:
            if not isinstance(leaf, ClassMethodNode):
                raise ValueError(
                    f"compiled DAG outputs must be actor method calls, got "
                    f"{type(leaf).__name__}")

        # One channel per (consumer, slot) dynamic edge; writers fan out.
        # node id -> list of channels its result feeds
        fanout: Dict[int, List[Channel]] = {}
        # channels the driver writes each execute(): (channel, key-or-None)
        self._input_feeds: List[Tuple[Channel, Any]] = []
        node_specs: Dict[int, Tuple[ClassMethodNode, list, dict]] = {}

        def spec_for(value, consumer_node) -> Tuple[str, Any]:
            if isinstance(value, InputNode):
                ch = self._new_channel(driver_node, consumer_node)
                self._input_feeds.append((ch, None))
                return ("chan", ch)
            if isinstance(value, InputAttributeNode):
                ch = self._new_channel(driver_node, consumer_node)
                self._input_feeds.append((ch, value._key))
                return ("chan", ch)
            if isinstance(value, ClassMethodNode):
                ch = self._new_channel(
                    actor_node.get(value._actor.actor_id), consumer_node)
                fanout.setdefault(id(value), []).append(ch)
                return ("chan", ch)
            if isinstance(value, DAGNode):
                raise ValueError(
                    f"unsupported node in compiled DAG: {type(value).__name__}")
            return ("const", value)

        for n in order:
            if isinstance(n, ClassMethodNode):
                consumer = actor_node.get(n._actor.actor_id)
                arg_specs = [spec_for(a, consumer) for a in n._bound_args]
                kwarg_specs = {k: spec_for(v, consumer)
                               for k, v in n._bound_kwargs.items()}
                node_specs[id(n)] = (n, arg_specs, kwarg_specs)

        # Driver-read output channels, one per leaf.
        self._output_channels: List[Channel] = []
        for leaf in leaves:
            ch = self._new_channel(
                actor_node.get(leaf._actor.actor_id), driver_node)
            fanout.setdefault(id(leaf), []).append(ch)
            self._output_channels.append(ch)

        # Start the resident loops (one __rtpu_apply__ round, await all).
        self._stop_feeds = [ch for ch, _ in self._input_feeds]
        self._all_channels = (
            [ch for ch, _ in self._input_feeds]
            + self._output_channels
            + [ch for chans in fanout.values() for ch in chans])
        refs = []
        for _, (node, arg_specs, kwarg_specs) in node_specs.items():
            outs = fanout.get(id(node), [])
            refs.append(node._actor.__rtpu_apply__.remote(
                _dag_actor_loop, node._method_name, arg_specs, kwarg_specs,
                outs))
        api.get(refs)

    # -- execution ---------------------------------------------------------
    def execute(self, *input_vals) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("compiled DAG was torn down")
        input_val = input_vals[0] if input_vals else None
        with self._lock:
            for ch, key in self._input_feeds:
                if key is None:
                    ch.write(input_val)
                elif isinstance(key, str) and not isinstance(input_val, dict):
                    ch.write(getattr(input_val, key))
                else:
                    ch.write(input_val[key])
            ref = CompiledDAGRef(self, self._seq)
            self._seq += 1
        return ref

    def _fetch(self, seq: int, timeout: Optional[float]):
        with self._lock:
            while seq not in self._results:
                vals = [ch.read(timeout=timeout)
                        for ch in self._output_channels]
                self._results[self._next_read] = (
                    vals if self._multi_output else vals[0])
                self._next_read += 1
            result = self._results.pop(seq)
        payloads = result if isinstance(result, list) else [result]
        for p in payloads:
            if isinstance(p, _ExcPayload):
                raise p.exc
        return result

    def teardown(self):
        if self._torn_down:
            return
        self._torn_down = True
        for ch in self._stop_feeds:
            try:
                ch.write(STOP, timeout=5.0)
            except Exception:
                pass
        # reclaim driver-host shm segments once the stop has flowed
        # through; each actor loop unlinks its own node's in-edges on exit
        def _unlink_later(channels=list({id(c): c
                                         for c in self._all_channels
                                         }.values())):
            import time as _time

            _time.sleep(0.2)
            for ch in channels:
                ch.unlink_native()

        threading.Thread(target=_unlink_later, daemon=True).start()
