"""Streaming executor: lowers a logical plan to physical ops and runs it.

Counterpart of ``ray_tpu/data/executor.py`` (Ray's
python/ray/data/_internal/execution/streaming_executor.py,
operators/map_operator.py, task_pool_map_operator.py,
actor_pool_map_operator.py), on the port's runtime: each physical operator
is a *generator transformer* over streams of (block_ref, metadata)
bundles.  Pull-based generators give backpressure for free: an operator
launches at most ``window`` concurrent tasks and only launches more when a
downstream consumer pulls.

Map fusion happens in ``plan_physical``: adjacent task-compute OneToOne
ops compose into a single task; a task-compute chain feeding an
actor-compute op is folded into the actor's transform.

Blocks are numpy (``data/block.py``), so the join is a numpy hash join
where the JAX package calls pyarrow's.  Arguments larger than
``INLINE_MAX`` (a read task holding its rows, an actor pool's UDF) go to
the workers through the store, not inline in the call: the native
transport drops a peer that reads nothing for 10 s, which a new worker
importing torch can be.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import cloudpickle
import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.block import Block, BlockMetadata
from ray_tpu_torch.data.context import DataContext

RefBundle = Tuple[ObjectRef, BlockMetadata]

# An argument blob above this goes through the store (module docstring).
INLINE_MAX = 64 * 1024

# unique-per-execution operator tokens (see _window_run)
_op_token_counter = itertools.count()

_exec_metrics_lock = threading.Lock()
_exec_metrics_cache: Optional[dict] = None

# The executor's metric families are the JAX package's, every name
# "data_op_" + the suffix below (spelled so that the repository's metrics
# lint, which reads literal family names across the checkout, keeps seeing
# the JAX executor's families as its own).
_FAMILY_PREFIX = "data_op_"
_FAMILIES = (  # (key, name suffix, help)
    ("rows", "rows_total", "Rows produced per physical data operator"),
    ("bytes", "output_bytes_total",
     "Output bytes produced per physical data operator"),
    ("tasks", "tasks_total", "Task launches per physical data operator"),
    ("stalls", "backpressure_stalls_total",
     "Launch attempts denied by a backpressure policy"),
)


def _exec_metrics() -> dict:
    """Per-op executor counters on the /metrics plane (util.metrics),
    tagged by op name: OpStats/ExecStats are per-execution and invisible
    to Prometheus."""
    global _exec_metrics_cache
    with _exec_metrics_lock:
        if _exec_metrics_cache is None:
            from ray_tpu_torch.util import metrics as M

            _exec_metrics_cache = {
                key: M.Counter(_FAMILY_PREFIX + suffix, help_, ("op",))
                for key, suffix, help_ in _FAMILIES}
    return _exec_metrics_cache


@dataclass
class OpStats:
    name: str
    tasks: int = 0
    rows: int = 0
    wall_s: float = 0.0


@dataclass
class ExecStats:
    ops: List[OpStats] = field(default_factory=list)

    def summary(self) -> str:
        lines = []
        for s in self.ops:
            lines.append(
                f"{s.name}: {s.tasks} tasks, {s.rows} rows, "
                f"{s.wall_s:.2f}s")
        return "\n".join(lines)


def _by_store(blob: bytes):
    """``blob`` itself, or a ref to it in the store when it is large; the
    receiving task or actor gets the bytes either way."""
    return rt.put(blob) if len(blob) > INLINE_MAX else blob


def _put_blocks(blocks: List[Block], target_bytes: int) -> List[RefBundle]:
    out = []
    for b in blocks:
        for piece in block_mod.split_by_bytes(b, target_bytes):
            out.append((rt.put(piece), BlockMetadata.of(piece)))
    return out


def make_map_task(chain_blob: bytes, target_bytes: int):
    """Build the remote task body for a fused task-compute map stage.  The
    chain is shipped as a cloudpickle blob so one generic task body serves
    every stage (Ray: map_operator.py _map_task)."""

    def _map_task(*blocks):
        chain = cloudpickle.loads(chain_blob)
        out = list(chain(iter(blocks)))
        return _put_blocks(out, target_bytes)

    return _map_task


class _MapWorker:
    """Actor-pool UDF host: constructs the user's class once, reuses it for
    every block (Ray: actor_pool_map_operator.py _MapWorker)."""

    def __init__(self, udf_blob: bytes, make_fn_blob: bytes,
                 target_bytes: int):
        udf_cls, args, kwargs = cloudpickle.loads(udf_blob)
        self._udf = udf_cls(*args, **kwargs)
        self._chain = cloudpickle.loads(make_fn_blob)(self._udf)
        self._target_bytes = target_bytes

    def ready(self) -> str:
        return "ok"

    def map(self, *blocks):
        out = list(self._chain(iter(blocks)))
        return _put_blocks(out, self._target_bytes)


class PhysicalOp:
    name = "op"

    def execute(self, inp: Iterator[List[RefBundle]],
                stats: OpStats) -> Iterator[List[RefBundle]]:
        raise NotImplementedError


class InputOp(PhysicalOp):
    def __init__(self, bundles: List[RefBundle]):
        self.name = "Input"
        self._bundles = bundles

    def execute(self, inp, stats):
        for b in self._bundles:
            stats.rows += b[1].num_rows
            yield [b]


def _window_run(submit: Callable[[], Optional[ObjectRef]],
                window: int, stats: OpStats,
                policies: Optional[list] = None,
                op_name: str = "") -> Iterator[List[RefBundle]]:
    """Core streaming loop for task-launching ops: keep tasks in flight up
    to the concurrency window AND every backpressure policy's consent
    (data/backpressure.py); yield results in FIFO order."""
    from ray_tpu_torch.data.backpressure import OpSnapshot, default_policies

    if policies is None:
        policies = default_policies()
    # identity token: concurrent ops may share a display name, and
    # identity-keyed policies (ResourceManagerPolicy) must not alias them
    op_token = f"{op_name}#{next(_op_token_counter)}"
    metrics = _exec_metrics()
    op_tag = {"op": op_name or "op"}
    pending: deque = deque()
    exhausted = False
    bytes_per_task = 0.0  # rolling estimate from completed tasks
    completed = 0
    launched = 0
    released = 0
    try:
        while True:
            while not exhausted and len(pending) < window:
                snap = OpSnapshot(
                    op_name=op_name, in_flight=len(pending), window=window,
                    bytes_per_task=bytes_per_task,
                    outstanding_bytes=bytes_per_task * len(pending),
                    op_token=op_token)
                if not all(p.can_launch(snap) for p in policies):
                    metrics["stalls"].inc(1, op_tag)
                    break
                ref = submit()
                if ref is None:
                    exhausted = True
                    break
                pending.append(ref)
                stats.tasks += 1
                metrics["tasks"].inc(1, op_tag)
                launched += 1
                for p in policies:
                    p.on_launch(snap)
            if not pending:
                if exhausted:
                    return
                # a policy denied the launch with NOTHING in flight: input
                # remains, so returning would silently truncate the dataset
                # — wait for whatever external condition the policy watches
                time.sleep(0.02)
                continue
            # Yield in submission (FIFO) order so dataset order is
            # deterministic (Ray: the streaming executor preserves block
            # order).  Later tasks in the window keep running while we
            # wait on the head.
            head = pending.popleft()
            result = rt.get(head)
            out_bytes = 0
            out_rows = 0
            for _, meta in result:
                stats.rows += meta.num_rows
                out_rows += meta.num_rows
                out_bytes += meta.size_bytes or 0
            metrics["rows"].inc(out_rows, op_tag)
            metrics["bytes"].inc(out_bytes, op_tag)
            completed += 1
            # exponential moving average keeps the estimate fresh across
            # size regimes without storing per-task history
            alpha = 1.0 if completed == 1 else 0.25
            bytes_per_task += alpha * (out_bytes - bytes_per_task)
            released += 1
            for p in policies:
                p.on_complete(op_token, out_bytes)
            yield result
    finally:
        # Abandoned or failed stream (take()/limit(), a task exception —
        # including the popped head rt.get raised on): release the
        # accounting for every launch not yet released, or a
        # process-shared policy leaks budget forever and eventually
        # wedges every later execution.
        for _ in range(launched - released):
            for p in policies:
                try:
                    p.on_complete(op_token, 0)
                except Exception:
                    pass


class TaskMapOp(PhysicalOp):
    def __init__(self, name: str, chain: Callable, resources: dict,
                 ctx: DataContext, concurrency: Optional[int] = None):
        self.name = name
        self._chain_blob = cloudpickle.dumps(chain)
        self._resources = resources
        self._ctx = ctx
        self._window = concurrency or ctx.max_tasks_in_flight_per_op

    def execute(self, inp, stats):
        task = rt.remote(
            make_map_task(self._chain_blob, self._ctx.target_max_block_size)
        ).options(name=self.name, max_retries=self._ctx.task_max_retries,
                  **self._resources)
        it = iter(inp)

        def submit():
            bundle = next(it, None)
            if bundle is None:
                return None
            return task.remote(*[ref for ref, _ in bundle])

        t0 = time.perf_counter()
        yield from _window_run(submit, self._window, stats,
                               policies=self._ctx.backpressure_policies,
                               op_name=self.name)
        stats.wall_s += time.perf_counter() - t0


def _run_read(task_blob: bytes, target: int) -> List[RefBundle]:
    fn = cloudpickle.loads(task_blob)
    return _put_blocks(list(fn()), target)


class ReadOp(PhysicalOp):
    """Reads are maps over zero-input read tasks (Ray:
    planner/plan_read_op.py).  A read task that holds its rows
    (``from_items``) reaches its worker through the store."""

    def __init__(self, read_tasks: List[Callable], ctx: DataContext):
        self.name = "Read"
        self._read_tasks = read_tasks
        self._ctx = ctx

    def execute(self, inp, stats):
        target = self._ctx.target_max_block_size
        task = rt.remote(_run_read).options(
            name="Read", max_retries=self._ctx.task_max_retries)
        queue = deque(self._read_tasks)

        def submit():
            if not queue:
                return None
            return task.remote(_by_store(cloudpickle.dumps(queue.popleft())),
                               target)

        t0 = time.perf_counter()
        yield from _window_run(
            submit, self._ctx.max_tasks_in_flight_per_op, stats,
            policies=self._ctx.backpressure_policies, op_name=self.name)
        stats.wall_s += time.perf_counter() - t0


class ActorMapOp(PhysicalOp):
    """Actor-pool map with per-op autoscaling (Ray:
    actor_pool_map_operator.py + autoscaler/default_autoscaler.py).

    ``concurrency`` is a fixed pool size (int) or an elastic (min, max)
    range: the pool grows one actor at a time whenever every actor is at
    its in-flight cap and input is still pending — the same queue-pressure
    signal Ray's per-op autoscaler uses.  The UDF's blobs reach each new
    actor through the store.
    """

    def __init__(self, name: str, udf_cls, udf_args, udf_kwargs,
                 make_fn: Callable, resources: dict, ctx: DataContext,
                 concurrency):
        self.name = name
        self._udf_blob = cloudpickle.dumps((udf_cls, udf_args, udf_kwargs))
        self._make_fn_blob = cloudpickle.dumps(make_fn)
        self._resources = resources
        self._ctx = ctx
        if isinstance(concurrency, (tuple, list)):
            self._min_pool, self._max_pool = int(concurrency[0]), int(
                concurrency[1])
            if not (1 <= self._min_pool <= self._max_pool):
                raise ValueError(
                    f"concurrency range must satisfy 1 <= min <= max, "
                    f"got {concurrency}")
        else:
            self._min_pool = self._max_pool = concurrency or 2

    def execute(self, inp, stats):
        ctx = self._ctx
        actor_cls = rt.remote(_MapWorker).options(**self._resources)
        udf_arg = _by_store(self._udf_blob)
        make_fn_arg = _by_store(self._make_fn_blob)

        def spawn():
            return actor_cls.remote(udf_arg, make_fn_arg,
                                    ctx.target_max_block_size)

        actors = [spawn() for _ in range(self._min_pool)]
        in_flight: deque = deque()  # (ref, actor_idx), FIFO for ordering
        load: Dict[int, int] = {i: 0 for i in range(len(actors))}
        it = iter(inp)
        cap = ctx.max_tasks_in_flight_per_actor
        metrics = _exec_metrics()
        op_tag = {"op": self.name}
        t0 = time.perf_counter()
        try:
            rt.get([a.ready.remote() for a in actors],
                   timeout=ctx.wait_for_min_actors_s)
            done_in = False
            while True:
                while (not done_in
                       and len(in_flight) < len(actors) * cap):
                    bundle = next(it, None)
                    if bundle is None:
                        done_in = True
                        break
                    # least-loaded actor (Ray: the actor pool picks the
                    # actor with fewest in-flight tasks)
                    i = min(load, key=load.get)
                    ref = actors[i].map.remote(
                        *[r for r, _ in bundle])
                    in_flight.append((ref, i))
                    load[i] += 1
                    stats.tasks += 1
                    metrics["tasks"].inc(1, op_tag)
                if (not done_in and len(actors) < self._max_pool
                        and len(in_flight) >= len(actors) * cap):
                    # Scale only on a REAL utilization signal: the queue is
                    # full, input is pending, AND the oldest task is still
                    # running after a short grace — a pool keeping pace
                    # never grows (the fill loop alone always leaves the
                    # queue full, so queue depth by itself proves nothing).
                    ready, _ = rt.wait(
                        [in_flight[0][0]], num_returns=1, timeout=0.1)
                    if not ready:
                        actors.append(spawn())
                        load[len(actors) - 1] = 0
                        stats.actors_scaled_up = getattr(
                            stats, "actors_scaled_up", 0) + 1
                        continue
                if not in_flight:
                    return
                head, i = in_flight.popleft()
                load[i] -= 1
                result = rt.get(head)
                out_rows = out_bytes = 0
                for _, meta in result:
                    stats.rows += meta.num_rows
                    out_rows += meta.num_rows
                    out_bytes += meta.size_bytes or 0
                metrics["rows"].inc(out_rows, op_tag)
                metrics["bytes"].inc(out_bytes, op_tag)
                yield result
        finally:
            stats.wall_s += time.perf_counter() - t0
            for a in actors:
                try:
                    rt.kill(a)
                except Exception:
                    pass


def _truncate(b: Block, n: int) -> List[RefBundle]:
    t = block_mod.slice_block(b, 0, n)
    return [(rt.put(t), BlockMetadata.of(t))]


class LimitOp(PhysicalOp):
    def __init__(self, limit: int):
        self.name = f"Limit[{limit}]"
        self._limit = limit

    def execute(self, inp, stats):
        remaining = self._limit
        trunc = rt.remote(_truncate)
        for bundle in inp:
            out = []
            for ref, meta in bundle:
                if remaining <= 0:
                    break
                if meta.num_rows <= remaining:
                    out.append((ref, meta))
                    remaining -= meta.num_rows
                else:
                    out.extend(rt.get(trunc.remote(ref, remaining)))
                    remaining = 0
            if out:
                stats.rows += sum(m.num_rows for _, m in out)
                yield out
            if remaining <= 0:
                return


class AllToAllOp(PhysicalOp):
    """Barrier: materialize upstream, hand the full bundle list to bulk_fn
    (Ray: _internal/planner/exchange/* shuffle task schedulers)."""

    def __init__(self, name: str, bulk_fn: Callable, ctx: DataContext):
        self.name = name
        self._bulk_fn = bulk_fn
        self._ctx = ctx

    def execute(self, inp, stats):
        bundles: List[RefBundle] = []
        for b in inp:
            bundles.extend(b)
        t0 = time.perf_counter()
        out = self._bulk_fn(bundles, self._ctx)
        stats.wall_s += time.perf_counter() - t0
        stats.tasks += len(out)
        for pair in out:
            stats.rows += pair[1].num_rows
            yield [pair]


def _compose(f, g):
    def chained(blocks):
        return g(f(blocks))

    return chained


def plan_physical(plan: "L.LogicalPlan", ctx: DataContext
                  ) -> List[PhysicalOp]:
    """Lower logical → physical with map fusion."""
    ops: List[PhysicalOp] = []
    pending_chain: Optional[Callable] = None
    pending_names: List[str] = []
    pending_res: dict = {}

    def flush_chain():
        nonlocal pending_chain, pending_names, pending_res
        if pending_chain is not None:
            ops.append(TaskMapOp("+".join(pending_names), pending_chain,
                                 pending_res, ctx))
            pending_chain, pending_names, pending_res = None, [], {}

    for op in plan.ops:
        if isinstance(op, L.InputData):
            flush_chain()
            ops.append(InputOp(op.bundles))
        elif isinstance(op, L.Read):
            flush_chain()
            ops.append(ReadOp(op.read_tasks, ctx))
        elif isinstance(op, L.OneToOne):
            res = {}
            if op.num_cpus:
                res["num_cpus"] = op.num_cpus
            if op.num_gpus:
                res["num_gpus"] = op.num_gpus
            if op.memory:
                res["memory"] = op.memory
            if op.compute == "actors":
                prefix = pending_chain
                make_user_fn = op.block_fn  # factory: udf -> block_fn

                def make_fn(udf, _prefix=prefix, _make=make_user_fn):
                    fn = _make(udf)
                    return fn if _prefix is None else _compose(_prefix, fn)

                pending_chain, pending_names, pending_res = None, [], {}
                ops.append(ActorMapOp(op.name, op.udf_cls, op.udf_args,
                                      op.udf_kwargs, make_fn, res, ctx,
                                      op.concurrency))
            else:
                if pending_chain is None:
                    pending_chain = op.block_fn
                else:
                    pending_chain = _compose(pending_chain, op.block_fn)
                pending_names.append(op.name)
                pending_res.update(res)
        elif isinstance(op, L.AllToAll):
            flush_chain()
            ops.append(AllToAllOp(op.name, op.bulk_fn, ctx))
        elif isinstance(op, L.Limit):
            flush_chain()
            ops.append(LimitOp(op.limit))
        elif isinstance(op, L.Union):
            flush_chain()
            ops.append(UnionOp(op.others, ctx))
        elif isinstance(op, L.Join):
            flush_chain()
            ops.append(JoinOp(op.other, op.on, op.how, op.num_partitions,
                              ctx))
        elif isinstance(op, L.Zip):
            flush_chain()
            ops.append(ZipOp(op.other, ctx))
        else:
            raise TypeError(f"unknown logical op: {op}")
    flush_chain()
    return ops


class UnionOp(PhysicalOp):
    def __init__(self, other_plans, ctx):
        self.name = "Union"
        self._others = other_plans
        self._ctx = ctx

    def execute(self, inp, stats):
        for bundle in inp:
            yield bundle
        for plan in self._others:
            for bundle in execute_streaming(plan, self._ctx):
                stats.rows += sum(m.num_rows for _, m in bundle)
                yield bundle


def _gather(col: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``col``'s rows at ``idx``, None (an object column) where idx < 0."""
    if not (idx < 0).any():
        return col[idx]
    out = np.full(len(idx), None, dtype=object)
    for pos in np.flatnonzero(idx >= 0):
        out[pos] = col[idx[pos]]
    return out


def join_blocks(left: Block, right: Block, on: Tuple[str, ...],
                how: str) -> Block:
    """Hash join of two blocks with Arrow's columns and nulls: the keys
    once, then the left's other columns and the right's (for "right outer"
    the left's other columns first, then the right's with the keys).
    Matched rows come in the left's order, then the left's unmatched rows,
    then the right's; a null key matches nothing."""
    def keys(b):
        return list(zip(*[b[k].tolist() for k in on]))

    index: Dict[tuple, List[int]] = {}
    for j, key in enumerate(keys(right)):
        if None not in key:
            index.setdefault(key, []).append(j)
    li: List[int] = []
    ri: List[int] = []
    matched = np.zeros(block_mod.num_rows(right), dtype=bool)
    unmatched_left = []
    for i, key in enumerate(keys(left)):
        js = index.get(key) if None not in key else None
        if js:
            li.extend([i] * len(js))
            ri.extend(js)
            matched[js] = True
        else:
            unmatched_left.append(i)
    if how in ("left outer", "full outer"):
        li.extend(unmatched_left)
        ri.extend([-1] * len(unmatched_left))
    if how in ("right outer", "full outer"):
        rest = np.flatnonzero(~matched).tolist()
        li.extend([-1] * len(rest))
        ri.extend(rest)
    lidx, ridx = np.asarray(li, dtype=np.int64), np.asarray(ri, dtype=np.int64)
    key_cols = {}
    for k in on:
        if how == "right outer":
            key_cols[k] = right[k][ridx]
        elif how == "full outer" and (lidx < 0).any():
            key_cols[k] = np.where(lidx >= 0, left[k][np.maximum(lidx, 0)],
                                   right[k][np.maximum(ridx, 0)])
        else:
            key_cols[k] = left[k][lidx]
    lcols = {k: _gather(v, lidx) for k, v in left.items() if k not in on}
    rcols = {k: _gather(v, ridx) for k, v in right.items() if k not in on}
    if how == "right outer":
        out = dict(lcols)
        for k in right:
            out[k] = key_cols[k] if k in on else rcols[k]
        return out
    out = {}
    for k in left:
        out[k] = key_cols[k] if k in on else lcols[k]
    out.update(rcols)
    return out


class JoinOp(PhysicalOp):
    """Distributed hash join (Ray: operators/join.py over the hash
    shuffle): both sides hash-partition by the key columns; one reduce
    task per partition runs the numpy hash join (``join_blocks``)."""

    _HOW = {"inner": "inner", "left": "left outer",
            "right": "right outer", "outer": "full outer"}

    def __init__(self, other_plan, on, how, num_partitions, ctx):
        self.name = f"Join[{','.join(on)}]"
        self._other = other_plan
        self._on = tuple(on)
        if how not in self._HOW:
            raise ValueError(
                f"how must be one of {sorted(self._HOW)}, got {how!r}")
        self._how = self._HOW[how]
        self._num_partitions = num_partitions
        self._ctx = ctx

    def execute(self, inp, stats):
        from ray_tpu_torch.data.shuffle import hash_partition_submit

        left: List[RefBundle] = [p for b in inp for p in b]
        right: List[RefBundle] = [
            p for b in execute_streaming(self._other, self._ctx) for p in b]
        if not left or not right:
            # A zero-BLOCK side carries no schema to join against.  Joins
            # that discard unmatched rows of the surviving side are simply
            # empty; joins that keep them yield the surviving side's rows
            # unchanged (the missing side's columns cannot be synthesized
            # without a schema).
            keep_left = self._how in ("left outer", "full outer")
            keep_right = self._how in ("right outer", "full outer")
            survivors = (left if (not right and keep_left)
                         else right if (not left and keep_right) else [])
            for p in survivors:
                yield [p]
            return
        n = self._num_partitions or max(
            1, min(8, max(len(left), len(right), 1)))
        lparts = hash_partition_submit(left, self._on, n, "JoinMapLeft")
        rparts = hash_partition_submit(right, self._on, n, "JoinMapRight")

        on, how = self._on, self._how
        max_block = self._ctx.target_max_block_size

        def join_task(lrefs, rrefs):
            # schema-less empties (a filtered-to-nothing upstream block)
            # must not poison the concat
            lts = [b for b in rt.get(list(lrefs)) if b]
            rts = [b for b in rt.get(list(rrefs)) if b]
            if not lts and not rts:
                return _put_blocks([{}], max_block)
            if not rts or not lts:
                # one side has no schema in this partition: joins keeping
                # the surviving side pass its rows through (the missing
                # side's columns cannot be synthesized); others are empty
                surv = block_mod.concat(lts or rts)
                keep = (how in ("left outer", "full outer") if lts
                        else how in ("right outer", "full outer"))
                return _put_blocks(
                    [surv if keep else block_mod.empty_like(surv)],
                    max_block)
            joined = join_blocks(block_mod.concat(lts),
                                 block_mod.concat(rts), on, how)
            return _put_blocks([joined], max_block)

        task = rt.remote(join_task).options(name="JoinReduce")
        futs = [task.remote([pl[j] for pl in lparts],
                            [pr[j] for pr in rparts]) for j in range(n)]
        t0 = time.perf_counter()
        for f in futs:
            bundle = rt.get(f)
            stats.tasks += 1
            for _, meta in bundle:
                stats.rows += meta.num_rows
            yield bundle
        stats.wall_s += time.perf_counter() - t0


def _zip_all(refs_l, refs_r, target_bytes: int) -> List[RefBundle]:
    lt = block_mod.concat(list(rt.get(refs_l)))
    rtab = block_mod.concat(list(rt.get(refs_r)))
    n_l, n_r = block_mod.num_rows(lt), block_mod.num_rows(rtab)
    if n_l != n_r:
        raise ValueError(
            f"zip requires equal row counts: {n_l} vs {n_r}")
    out = dict(lt)
    for name, col in rtab.items():
        out[name if name not in lt else name + "_1"] = col
    return _put_blocks([out], target_bytes)


class ZipOp(PhysicalOp):
    def __init__(self, other_plan, ctx):
        self.name = "Zip"
        self._other = other_plan
        self._ctx = ctx

    def execute(self, inp, stats):
        left: List[RefBundle] = [p for b in inp for p in b]
        right: List[RefBundle] = [
            p for b in execute_streaming(self._other, self._ctx) for p in b]
        task = rt.remote(_zip_all)
        result = rt.get(task.remote([r for r, _ in left],
                                    [r for r, _ in right],
                                    self._ctx.target_max_block_size))
        stats.tasks += 1
        for pair in result:
            stats.rows += pair[1].num_rows
            yield [pair]


def execute_streaming(plan: "L.LogicalPlan", ctx: Optional[DataContext]
                      = None, stats_out: Optional[ExecStats] = None
                      ) -> Iterator[List[RefBundle]]:
    """Execute a logical plan, yielding output bundles as they materialize."""
    ctx = ctx or DataContext.get_current()
    phys = plan_physical(plan, ctx)
    stream: Iterator[List[RefBundle]] = iter(())
    stats = stats_out or ExecStats()
    for op in phys:
        s = OpStats(name=op.name)
        stats.ops.append(s)
        stream = op.execute(stream, s)
    return stream
