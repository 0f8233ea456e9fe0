"""Dataset: lazy, streaming, distributed data over numpy blocks.

Counterpart of ``ray_tpu/data/dataset.py`` (Ray's python/ray/data/
dataset.py: map_batches, streaming_split, iter_batches, materialize), on
the port's runtime: transforms append logical ops (``data/logical.py``);
consumption plans and runs the streaming executor (``data/executor.py``).
``iter_torch_batches`` feeds a train loop on the card, and
``streaming_split`` hands each train worker its own shard, fed by one
coordinator actor (``data/split.py``).

Blocks are ``{column: ndarray}`` (``data/block.py``), so ``schema()`` is
``{column: (dtype, trailing shape)}`` where the JAX package returns a
pyarrow schema.  ``iter_jax_batches`` raises: the port imports no JAX.
``iter_tf_batches`` and ``to_tf`` import tensorflow when called (the
card's host has none), ``to_pandas`` and ``to_arrow`` pyarrow, and so do
the Parquet and CSV writes; the ``write_*`` methods write one file a
block (``datasource.make_write_fn``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import cloudpickle
import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data import shuffle as shuffle_mod
from ray_tpu_torch.data.block import Block, BlockMetadata
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.executor import ExecStats, execute_streaming
from ray_tpu_torch.data.iterator import DataIterator, _BundleIterable

# The streaming_split coordinator's start call.
SPLIT_START_TIMEOUT_S = 120


def _batch_transform(fn: Callable, batch_format: str, batch_size: Optional[int],
                     fn_args: tuple, fn_kwargs: dict) -> Callable:
    """Wrap a user batch UDF into a block transform iter[Block]->iter[Block]."""

    def transform(blocks: Iterator[Block]) -> Iterator[Block]:
        def batches():
            if batch_size is None:
                for b in blocks:
                    if block_mod.num_rows(b):
                        yield b
                return
            # re-slice the stream into exact batch_size chunks
            buf: List[Block] = []
            have = 0
            for b in blocks:
                n = block_mod.num_rows(b)
                while n:
                    take = min(batch_size - have, n)
                    buf.append(block_mod.slice_block(b, 0, take))
                    b = block_mod.slice_block(b, take, n)
                    n -= take
                    have += take
                    if have == batch_size:
                        yield block_mod.concat(buf)
                        buf, have = [], 0
            if buf:
                yield block_mod.concat(buf)

        for batch_block in batches():
            batch = block_mod.to_batch(batch_block, batch_format)
            out = fn(batch, *fn_args, **fn_kwargs)
            yield block_mod.from_batch(out)

    return transform


def _row_transform(kind: str, fn: Callable) -> Callable:
    def transform(blocks: Iterator[Block]) -> Iterator[Block]:
        for b in blocks:
            rows = block_mod.rows_of(b)
            if kind == "map":
                out = [fn(r) for r in rows]
            elif kind == "flat_map":
                out = [o for r in rows for o in fn(r)]
            elif kind == "filter":
                out = [r for r in rows if fn(r)]
            else:
                raise ValueError(kind)
            yield block_mod.from_rows(out)

    return transform


class Dataset:
    def __init__(self, plan: L.LogicalPlan):
        self._plan = plan
        self._last_stats: Optional[ExecStats] = None

    # ------------------------- transforms --------------------------------

    def _one_to_one(self, name: str, block_fn=None, **kw) -> "Dataset":
        op = L.OneToOne(name=name, block_fn=block_fn, **kw)
        return Dataset(self._plan.with_op(op))

    def map_batches(self, fn: Union[Callable, type], *,
                    batch_size: Optional[int] = "default",
                    batch_format: str = "numpy",
                    compute: Optional[str] = None,
                    fn_args: tuple = (), fn_kwargs: Optional[dict] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None,
                    concurrency: Optional[int] = None,
                    num_cpus: Optional[float] = None,
                    num_gpus: Optional[float] = None,
                    memory: Optional[float] = None,
                    **_ignored) -> "Dataset":
        """A class UDF selects actor compute: the pool constructs one
        instance per actor (Ray's dataset.py 'Stateful Transforms').
        ``num_gpus`` (the JAX package's ``num_tpus``) is each task's or
        actor's share of a card; ``concurrency`` an int or a (min, max)
        range of actors."""
        if batch_size == "default":
            batch_size = DataContext.get_current().target_batch_size
        fn_kwargs = fn_kwargs or {}
        is_class = isinstance(fn, type)
        name = f"MapBatches({getattr(fn, '__name__', 'fn')})"
        if not is_class and compute == "actors":
            # Plain function with actor compute: wrap it so the pool's
            # per-actor "constructor" just captures the function.
            user_fn = fn

            class _FnWrapper:  # noqa: N801 — internal
                def __call__(self, batch, *a, **k):
                    return user_fn(batch, *a, **k)

            fn = _FnWrapper
            is_class = True
        if is_class:
            def make_fn(udf, _bs=batch_size, _bf=batch_format,
                        _a=fn_args, _k=fn_kwargs):
                return _batch_transform(udf, _bf, _bs, _a, _k)

            return self._one_to_one(
                name, block_fn=make_fn, compute="actors", udf_cls=fn,
                udf_args=fn_constructor_args,
                udf_kwargs=fn_constructor_kwargs or {},
                concurrency=concurrency, num_cpus=num_cpus,
                num_gpus=num_gpus, memory=memory)
        return self._one_to_one(
            name,
            block_fn=_batch_transform(fn, batch_format, batch_size,
                                      fn_args, fn_kwargs),
            concurrency=concurrency, num_cpus=num_cpus, num_gpus=num_gpus,
            memory=memory)

    def map(self, fn: Callable, **kw) -> "Dataset":
        return self._one_to_one(f"Map({getattr(fn, '__name__', 'fn')})",
                                block_fn=_row_transform("map", fn))

    def flat_map(self, fn: Callable, **kw) -> "Dataset":
        return self._one_to_one(f"FlatMap({getattr(fn, '__name__', 'fn')})",
                                block_fn=_row_transform("flat_map", fn))

    def filter(self, fn: Callable, **kw) -> "Dataset":
        return self._one_to_one(f"Filter({getattr(fn, '__name__', 'fn')})",
                                block_fn=_row_transform("filter", fn))

    def select_columns(self, cols: List[str]) -> "Dataset":
        def transform(blocks):
            for b in blocks:
                yield {c: b[c] for c in cols}

        return self._one_to_one(f"Select{cols}", block_fn=transform)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def transform(blocks):
            for b in blocks:
                yield {c: v for c, v in b.items() if c not in cols}

        return self._one_to_one(f"Drop{cols}", block_fn=transform)

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def transform(blocks):
            for b in blocks:
                col = fn(block_mod.to_batch(b, "numpy"))
                yield {**b, name: np.asarray(col)}

        return self._one_to_one(f"AddColumn[{name}]", block_fn=transform)

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def transform(blocks):
            for b in blocks:
                yield {mapping.get(c, c): v for c, v in b.items()}

        return self._one_to_one("RenameColumns", block_fn=transform)

    # ------------------------- all-to-all --------------------------------

    def repartition(self, num_blocks: int) -> "Dataset":
        op = L.AllToAll(name=f"Repartition[{num_blocks}]",
                        bulk_fn=shuffle_mod.repartition_fn(num_blocks))
        return Dataset(self._plan.with_op(op))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        op = L.AllToAll(name="RandomShuffle",
                        bulk_fn=shuffle_mod.random_shuffle_fn(seed))
        return Dataset(self._plan.with_op(op))

    def randomize_block_order(self, *, seed: Optional[int] = None
                              ) -> "Dataset":
        def bulk(bundles, ctx):
            rng = np.random.default_rng(seed)
            order = rng.permutation(len(bundles))
            return [bundles[i] for i in order]

        return Dataset(self._plan.with_op(
            L.AllToAll(name="RandomizeBlockOrder", bulk_fn=bulk)))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        op = L.AllToAll(name=f"Sort[{key}]",
                        bulk_fn=shuffle_mod.sort_fn(key, descending))
        return Dataset(self._plan.with_op(op))

    def groupby(self, key: Optional[str]) -> "GroupedData":
        return GroupedData(self, key)

    def limit(self, n: int) -> "Dataset":
        return Dataset(self._plan.with_op(L.Limit(name=f"Limit[{n}]",
                                                  limit=n)))

    def union(self, *others: "Dataset") -> "Dataset":
        op = L.Union(name="Union", others=[o._plan for o in others])
        return Dataset(self._plan.with_op(op))

    def zip(self, other: "Dataset") -> "Dataset":
        return Dataset(self._plan.with_op(
            L.Zip(name="Zip", other=other._plan)))

    def join(self, other: "Dataset", on, *, how: str = "inner",
             num_partitions: Optional[int] = None) -> "Dataset":
        """Distributed hash join on key column(s) (Ray: dataset join via
        _internal/execution/operators/join.py).

        how: "inner" | "left" | "right" | "outer".
        """
        keys = (on,) if isinstance(on, str) else tuple(on)
        return Dataset(self._plan.with_op(L.Join(
            name=f"Join[{','.join(keys)}]", other=other._plan, on=keys,
            how=how, num_partitions=num_partitions)))

    # global aggregations (Ray's dataset.py sum/min/max/mean/std)
    def _scalar(self, col: str):
        rows = self.take_all()
        return rows[0][col] if rows else None

    def sum(self, on: str):
        return self.groupby(None).sum(on)._scalar(f"sum({on})")

    def min(self, on: str):
        return self.groupby(None).min(on)._scalar(f"min({on})")

    def max(self, on: str):
        return self.groupby(None).max(on)._scalar(f"max({on})")

    def mean(self, on: str):
        return self.groupby(None).mean(on)._scalar(f"mean({on})")

    def std(self, on: str):
        return self.groupby(None).std(on)._scalar(f"std({on})")

    # ------------------------- execution ---------------------------------

    def _execute(self) -> Iterator[List[Tuple[Any, BlockMetadata]]]:
        self._last_stats = ExecStats()
        return execute_streaming(self._plan, stats_out=self._last_stats)

    def iter_bundles(self) -> Iterator[Tuple[Any, BlockMetadata]]:
        for bundle in self._execute():
            yield from bundle

    def materialize(self) -> "MaterializedDataset":
        bundles = list(self.iter_bundles())
        return MaterializedDataset(
            L.LogicalPlan([L.InputData(name="Input", bundles=bundles)]),
            bundles)

    def count(self) -> int:
        return sum(m.num_rows for _, m in self.iter_bundles())

    def schema(self) -> Optional[Dict[str, tuple]]:
        """``{column: (numpy dtype, trailing shape)}`` of the first block
        with a column."""
        for ref, meta in self.iter_bundles():
            b = rt.get(ref)
            if b:
                return block_mod.schema_of(b)
        return None

    def columns(self) -> List[str]:
        return list(self.schema() or {})

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for ref, meta in self.limit(n).iter_bundles():
            out.extend(block_mod.rows_of(rt.get(ref)))
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for ref, _ in self.iter_bundles():
            out.extend(block_mod.rows_of(rt.get(ref)))
        return out

    def take_batch(self, n: int = 20, batch_format: str = "numpy"):
        blocks = [rt.get(ref) for ref, _ in self.limit(n).iter_bundles()]
        if not blocks:
            return {}
        tbl = block_mod.slice_block(block_mod.concat(blocks), 0, n)
        return block_mod.to_batch(tbl, batch_format)

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def to_pandas(self):
        table = self.to_arrow()
        return table.to_pandas() if table is not None else None

    def to_arrow(self):
        """The rows as one pyarrow table (``block.to_arrow``), None for no
        block."""
        blocks = [rt.get(ref) for ref, _ in self.iter_bundles()]
        return (block_mod.to_arrow(block_mod.concat(blocks)) if blocks
                else None)

    def stats(self) -> str:
        if self._last_stats is None:
            return "(not executed yet)"
        return self._last_stats.summary()

    # ------------------------- iteration ---------------------------------

    def iterator(self) -> DataIterator:
        return DataIterator(_BundleIterable(self.iter_bundles))

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for ref, _ in self.iter_bundles():
            yield from block_mod.rows_of(rt.get(ref))

    def iter_batches(self, **kw) -> Iterator[Any]:
        return self.iterator().iter_batches(**kw)

    def iter_jax_batches(self, **kw) -> Iterator[Any]:
        return self.iterator().iter_jax_batches(**kw)

    def iter_torch_batches(self, **kw) -> Iterator[Any]:
        return self.iterator().iter_torch_batches(**kw)

    def iter_tf_batches(self, **kw) -> Iterator[Any]:
        return self.iterator().iter_tf_batches(**kw)

    def to_tf(self, feature_columns, label_columns, **kw):
        return self.iterator().to_tf(feature_columns, label_columns, **kw)

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List[DataIterator]:
        """n shards fed by one coordinator actor, which executes the plan
        once and deals its output bundles round-robin (Ray's dataset.py
        streaming_split).  ``equal`` and ``locality_hints`` are accepted
        and unused, as in the JAX package."""
        from ray_tpu_torch.data.split import ShardIterable, SplitCoordinator

        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        # the plan through the store (data/split.py)
        plan = rt.put(cloudpickle.dumps(self._plan))
        coord = rt.remote(SplitCoordinator).options(
            num_cpus=0, max_concurrency=2 * n + 2).remote(plan, n)
        rt.get(coord.start.remote(), timeout=SPLIT_START_TIMEOUT_S)
        return [DataIterator(ShardIterable(coord, i)) for i in range(n)]

    # ------------------------- writes ------------------------------------

    def _write(self, path: str, fmt: str, **kw) -> None:
        from ray_tpu_torch.data.datasource import make_write_fn

        ds = self._one_to_one(f"Write[{fmt}]",
                              block_fn=make_write_fn(path, fmt, kw))
        for _ in ds.iter_bundles():
            pass

    def write_parquet(self, path: str, **kw) -> None:
        self._write(path, "parquet", **kw)

    def write_csv(self, path: str, **kw) -> None:
        self._write(path, "csv", **kw)

    def write_tfrecords(self, path: str, **kw) -> None:
        self._write(path, "tfrecords", **kw)

    def write_json(self, path: str, **kw) -> None:
        self._write(path, "json", **kw)

    def write_avro(self, path: str, **kw) -> None:
        self._write(path, "avro", **kw)

    def __repr__(self):
        return f"Dataset({self._plan!r})"


class MaterializedDataset(Dataset):
    """Execution already happened; blocks are pinned in the object store
    (Ray's dataset.py MaterializedDataset)."""

    def __init__(self, plan: L.LogicalPlan, bundles):
        super().__init__(plan)
        self._bundles = bundles

    def count(self) -> int:
        return sum(m.num_rows for _, m in self._bundles)

    def num_blocks(self) -> int:
        return len(self._bundles)


class GroupedData:
    """Ray: python/ray/data/grouped_data.py."""

    def __init__(self, ds: Dataset, key: Optional[str]):
        self._ds = ds
        self._key = key

    def _agg(self, aggs: List[Tuple[str, Optional[str]]]) -> Dataset:
        op = L.AllToAll(
            name=f"Aggregate[{self._key}]",
            bulk_fn=shuffle_mod.groupby_agg_fn(self._key, aggs))
        return Dataset(self._ds._plan.with_op(op))

    def count(self) -> Dataset:
        return self._agg([("count", None)])

    def sum(self, on: str) -> Dataset:
        return self._agg([("sum", on)])

    def min(self, on: str) -> Dataset:
        return self._agg([("min", on)])

    def max(self, on: str) -> Dataset:
        return self._agg([("max", on)])

    def mean(self, on: str) -> Dataset:
        return self._agg([("mean", on)])

    def std(self, on: str) -> Dataset:
        return self._agg([("std", on)])

    def aggregate(self, *aggs: Tuple[str, Optional[str]]) -> Dataset:
        return self._agg(list(aggs))

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy"
                   ) -> Dataset:
        """Sort by key, then apply fn per group (Ray: grouped_data.py
        map_groups)."""
        key = self._key
        sorted_ds = self._ds.sort(key)

        def transform(blocks: Iterator[Block]) -> Iterator[Block]:
            tbl = block_mod.concat(list(blocks))
            if block_mod.num_rows(tbl) == 0:
                return
            vals = tbl[key].tolist()
            start = 0
            for i in range(1, len(vals) + 1):
                if i == len(vals) or vals[i] != vals[start]:
                    group = block_mod.slice_block(tbl, start, i)
                    out = fn(block_mod.to_batch(group, batch_format))
                    yield block_mod.from_batch(out)
                    start = i

        # group boundaries can span blocks: concat everything in one task
        return Dataset(sorted_ds._plan.with_op(L.AllToAll(
            name="MapGroups",
            bulk_fn=_map_groups_bulk(transform))))


def _map_groups_bulk(transform):
    def bulk(bundles, ctx):
        def run(refs):
            blocks = list(rt.get(list(refs)))
            out = list(transform(iter(blocks)))
            return [(rt.put(b), BlockMetadata.of(b)) for b in out]

        task = rt.remote(run).options(name="MapGroups")
        return rt.get(task.remote([r for r, _ in bundles]))

    return bulk
