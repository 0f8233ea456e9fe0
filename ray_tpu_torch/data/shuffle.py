"""All-to-all exchanges: repartition, random_shuffle, sort, groupby.

Counterpart of ``ray_tpu/data/shuffle.py`` (Ray's
python/ray/data/_internal/planner/exchange/shuffle_task_scheduler.py,
sort_task_spec.py, and the hash_shuffle / hash_aggregate operators):
two-phase map/reduce over store refs — map tasks partition each input
block and ``put`` the pieces, reduce tasks fetch their partition's pieces
and combine.  All phases are ordinary tasks on the port's runtime.

The blocks are numpy, so each pyarrow compute call of the JAX package is
numpy here: ``take`` and ``filter`` are fancy indexing, ``sort_by`` a
stable argsort, ``group_by(...).aggregate`` a grouping by first
appearance.  The seeded shuffle draws the same numbers in the same order
as the JAX package's, so it gives its rows to the bit, and the hash
partitions are the JAX package's (crc32 of the values' repr).
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block, BlockMetadata


def _reduce_submit(parts_lists, num_parts: int, combine: Callable,
                   name: str) -> List[Tuple[Any, BlockMetadata]]:
    """Fan reduce tasks over partitions; parts_lists[i][j] = ref of input i's
    piece for partition j."""

    def reduce_task(piece_refs):
        blocks = [b for b in rt.get(list(piece_refs)) if b is not None]
        out = combine(block_mod.concat(blocks)) if blocks else {}
        return rt.put(out), BlockMetadata.of(out)

    task = rt.remote(reduce_task).options(name=name)
    futs = [task.remote([plist[j] for plist in parts_lists])
            for j in range(num_parts)]
    return [rt.get(f) for f in futs]


def _map_submit(bundles, map_fn: Callable, name: str) -> List[List[Any]]:
    """map_fn(block) -> list of blocks (one per partition); tasks put each
    piece and return its refs."""

    def map_task(b):
        return [rt.put(piece) for piece in map_fn(b)]

    task = rt.remote(map_task).options(name=name)
    futs = [task.remote(ref) for ref, _ in bundles]
    return [rt.get(f) for f in futs]


def _split(b: Block, assign: np.ndarray, n: int) -> List[Block]:
    """``b``'s rows by partition: piece j holds the rows assigned j."""
    return [block_mod.take(b, assign == j) for j in range(n)]


def repartition_fn(num_blocks: int):
    def bulk(bundles, ctx):
        total = sum(m.num_rows for _, m in bundles)
        bounds = np.linspace(0, total, num_blocks + 1, dtype=np.int64)
        # Assign each output block a global row range; map tasks slice out
        # the overlap of their input block with each range.
        starts = []
        acc = 0
        for _, m in bundles:
            starts.append(acc)
            acc += m.num_rows

        def map_task(b, start_row):
            n = block_mod.num_rows(b)
            pieces = []
            for j in range(num_blocks):
                lo = int(max(bounds[j] - start_row, 0))
                hi = int(min(bounds[j + 1] - start_row, n))
                pieces.append(block_mod.slice_block(b, lo, max(lo, hi)))
            return [rt.put(p) for p in pieces]

        task = rt.remote(map_task).options(name="RepartitionMap")
        parts = [rt.get(task.remote(ref, starts[i]))
                 for i, (ref, _) in enumerate(bundles)]
        return _reduce_submit(parts, num_blocks, lambda t: t,
                              "RepartitionReduce")

    return bulk


def random_shuffle_fn(seed: Optional[int] = None,
                      num_blocks: Optional[int] = None):
    def bulk(bundles, ctx):
        n_out = num_blocks or max(1, len(bundles))
        # Fresh entropy per unseeded shuffle so per-epoch shuffles differ.
        rng_seed = seed if seed is not None else int(
            np.random.SeedSequence().entropy % (2 ** 31))

        def map_task(b, i):
            n = block_mod.num_rows(b)
            rng = np.random.default_rng(rng_seed + 7919 * i)
            idx = rng.permutation(n)
            assign = rng.integers(0, n_out, size=n)
            shuffled = block_mod.take(b, idx)
            return [rt.put(p) for p in _split(shuffled, assign, n_out)]

        task = rt.remote(map_task).options(name="ShuffleMap")
        parts = [rt.get(task.remote(ref, i))
                 for i, (ref, _) in enumerate(bundles)]

        def combine(t, _seed=rng_seed):
            rng = np.random.default_rng(_seed ^ 0xABCDEF)
            n = block_mod.num_rows(t)
            if n == 0:
                return t
            return block_mod.take(t, rng.permutation(n))

        return _reduce_submit(parts, n_out, combine, "ShuffleReduce")

    return bulk


def _crc_partition(values: List[Any], n_parts: int) -> np.ndarray:
    """Deterministic cross-process hash (Python's hash() is salted per
    process and map tasks run in different workers): the JAX package's."""
    return np.asarray([zlib.crc32(repr(v).encode()) % n_parts
                       for v in values], dtype=np.int64)


def hash_partition_submit(bundles, keys: Tuple[str, ...], n_parts: int,
                          name: str) -> List[List[Any]]:
    """Hash-partition every bundle's block by key columns; returns
    parts[i][j] = ref of input i's piece for partition j (the map half of
    a hash shuffle — Ray: operators/hash_shuffle.py)."""

    def map_fn(b: Block) -> List[Block]:
        if block_mod.num_rows(b) == 0:
            return [b] * n_parts
        cols = [b[k].tolist() for k in keys]
        return _split(b, _crc_partition(list(zip(*cols)), n_parts), n_parts)

    return _map_submit(bundles, map_fn, name)


def _sample_boundaries(bundles, key: str, n_parts: int) -> List[Any]:
    """Sample input blocks to pick range-partition boundaries (Ray:
    sort_task_spec.py SortTaskSpec.sample_boundaries)."""

    def sample(b):
        n = block_mod.num_rows(b)
        k = min(100, n)
        if k == 0:
            return []
        idx = np.linspace(0, n - 1, k, dtype=np.int64)
        return b[key][idx].tolist()

    task = rt.remote(sample).options(name="SortSample")
    samples: List[Any] = []
    for vals in rt.get([task.remote(ref) for ref, _ in bundles]):
        samples.extend(vals)
    if not samples:
        return []
    samples.sort()
    return [samples[int(len(samples) * (j + 1) / n_parts) - 1]
            for j in range(n_parts - 1)]


def _stable_order(col: np.ndarray, descending: bool) -> np.ndarray:
    """Arrow's ``sort_by`` order: stable, ties kept in input order either
    way."""
    if not descending:
        return np.argsort(col, kind="stable")
    n = len(col)
    return (n - 1 - np.argsort(col[::-1], kind="stable"))[::-1]


def sort_fn(key: str, descending: bool = False):
    def bulk(bundles, ctx):
        if not bundles:
            return []
        n_out = max(1, len(bundles))
        bounds = _sample_boundaries(bundles, key, n_out)

        def map_task(b):
            col = b[key].tolist() if b else []
            if not bounds:
                assign = np.zeros(len(col), dtype=np.int64)
            else:
                try:
                    assign = np.searchsorted(np.asarray(bounds), col,
                                             side="left")
                except (TypeError, ValueError):
                    assign = np.asarray(
                        [sum(1 for bd in bounds if v > bd) for v in col],
                        dtype=np.int64)
            return [rt.put(p) for p in _split(b, assign, n_out)]

        task = rt.remote(map_task).options(name="SortMap")
        parts = [rt.get(task.remote(ref)) for ref, _ in bundles]

        def combine(t):
            if not t:
                return t
            return block_mod.take(t, _stable_order(t[key], descending))

        out = _reduce_submit(parts, n_out, combine, "SortReduce")
        return list(reversed(out)) if descending else out

    return bulk


def _valid(col: np.ndarray) -> np.ndarray:
    """The column without its nulls (None): Arrow's aggregates skip them."""
    if col.dtype == object:
        return col[np.asarray([v is not None for v in col], dtype=bool)]
    return col


def _aggregate(agg_name: str, col: np.ndarray):
    """One of Arrow's aggregates of a column, as a Python value (None where
    Arrow gives null: a column with no valid value)."""
    vals = _valid(col)
    if agg_name == "count":
        return int(len(vals))
    if len(vals) == 0:
        return None
    if vals.dtype == object:  # strings or Python numbers
        py = vals.tolist()
        if agg_name in ("min", "max"):
            return min(py) if agg_name == "min" else max(py)
        vals = np.asarray(py)
    if agg_name == "sum":
        return vals.sum().item()
    if agg_name == "min":
        return vals.min().item()
    if agg_name == "max":
        return vals.max().item()
    if agg_name == "mean":
        return float(np.mean(vals, dtype=np.float64))
    if agg_name == "std":  # Arrow's stddev: ddof 0
        return float(np.std(vals, dtype=np.float64))
    raise ValueError(f"unknown aggregate {agg_name!r}")


def _column(values: List[Any]) -> np.ndarray:
    """A 1-d column of Python values (object where one is None)."""
    if any(v is None for v in values):
        out = np.empty(len(values), dtype=object)
        out[:] = values
        return out
    return np.asarray(values)


def groupby_agg_fn(key: Optional[str], aggs: List[Tuple[str, Optional[str]]]):
    """aggs: list of (agg_name, on_column), agg_name one of count, sum,
    min, max, mean, std (Ray's AggregateFn zoo, python/ray/data/
    aggregate.py).  key=None → global aggregation.  Output columns are
    Arrow's: the key, then "<agg>(<col>)" ("count()")."""

    def bulk(bundles, ctx):
        n_out = max(1, min(len(bundles), 8)) if key else 1

        def map_task(b):
            if key is None:
                return [rt.put(b)]
            if not b:
                return [rt.put(b) for _ in range(n_out)]
            return [rt.put(p) for p in _split(
                b, _crc_partition(b[key].tolist(), n_out), n_out)]

        task = rt.remote(map_task).options(name="AggMap")
        parts = [rt.get(task.remote(ref)) for ref, _ in bundles]

        def combine(t):
            if block_mod.num_rows(t) == 0:
                return t
            specs = []
            for agg_name, on in aggs:
                col = on
                if col is None:
                    col = key or next(iter(t))
                label = f"{agg_name}({on})" if on else f"{agg_name}()"
                specs.append((agg_name, col, label))
            if key is None:
                return {label: _column([_aggregate(a, t[col])])
                        for a, col, label in specs}
            # groups in order of first appearance
            keys = t[key].tolist()
            first: Dict[Any, List[int]] = {}
            for i, k in enumerate(keys):
                first.setdefault(k, []).append(i)
            groups = [np.asarray(rows, dtype=np.int64)
                      for rows in first.values()]
            out = {key: t[key][[g[0] for g in groups]]}
            for a, col, label in specs:
                out[label] = _column([_aggregate(a, t[col][g])
                                      for g in groups])
            return out

        out = _reduce_submit(parts, n_out, combine, "AggReduce")
        return [(r, m) for r, m in out if m.num_rows > 0] or out[:1]

    return bulk
