"""Blocks: the unit of data movement, a dict of equal-length numpy columns.

Counterpart of ``ray_tpu/data/block.py``, whose block is a pyarrow Table.
The port's runs where there is no pyarrow (the GPU machine has none), so a
block is ``{column: ndarray}``: a multi-dim column (token rows, images)
keeps its trailing shape as it is, where the JAX package stores a
fixed-size list with the shape in the field's metadata.  The batch format
is "numpy"; "pandas" and "pyarrow" raise.  A null (a row without a
column, an outer join's missing side) is None in an object column, where
the JAX package holds an Arrow null, and a column of bytes is an object
column (a fixed-width bytes array would drop trailing zero bytes).
``from_arrow`` and ``to_arrow`` convert a block from and to a pyarrow
table, the layout the JAX package's blocks have, for the file readers and
writes that go through pyarrow; they import it when called.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np

Block = Dict[str, np.ndarray]

# Column name used when data has no schema (a range of ints, a list of
# scalars), as in the JAX package
VALUE_COL = "item"


def num_rows(block: Block) -> int:
    """The rows of ``block`` (0 for a block with no column)."""
    return len(next(iter(block.values()))) if block else 0


def size_bytes(block: Block) -> int:
    return sum(v.nbytes for v in block.values())


def schema_of(block: Block) -> Dict[str, tuple]:
    """``{column: (dtype, trailing shape)}``: the port's schema, where the
    JAX package returns a pyarrow schema."""
    return {k: (v.dtype, v.shape[1:]) for k, v in block.items()}


@dataclass
class BlockMetadata:
    """Sidecar facts about a block, computed where the block was produced so
    the driver never has to fetch the block to plan (Ray: block.py
    BlockMetadata)."""

    num_rows: int
    size_bytes: int
    schema_str: str = ""

    @staticmethod
    def of(block: Block) -> "BlockMetadata":
        return BlockMetadata(num_rows=num_rows(block),
                             size_bytes=size_bytes(block),
                             schema_str=str(schema_of(block)))


def from_rows(rows: Iterable[Any]) -> Block:
    """A block from row dicts (scalars become the ``"item"`` column).  Its
    columns are the union of every row's keys, in the order first seen; a
    row that lacks one gives None there."""
    rows = list(rows)
    if not rows:
        return {}
    if not isinstance(rows[0], dict):
        rows = [{VALUE_COL: r} for r in rows]
    cols: Dict[str, List[Any]] = {}
    for r in rows:
        for k in r:
            cols.setdefault(k, [])
    for r in rows:
        for k, col in cols.items():
            col.append(r.get(k))
    return from_batch(cols)


def _as_column(v: Any) -> np.ndarray:
    """A column from a batch's value.  An array stays as it is; a list of
    equal-shape arrays stacks into one multi-dim column; a list holding
    Python lists (Arrow's list column) or ragged arrays becomes an object
    column of its elements as they are, and so does a list holding bytes."""
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, (list, tuple)) and v:
        nested = any(isinstance(x, (list, tuple, bytes, bytearray))
                     for x in v)
        arrays = all(isinstance(x, np.ndarray) for x in v)
        if arrays and len({(x.shape, x.dtype) for x in v}) == 1:
            return np.stack(v)
        if nested or arrays:
            out = np.empty(len(v), dtype=object)
            for i, x in enumerate(v):
                out[i] = x
            return out
    return np.asarray(v)


def from_batch(batch: Any) -> Block:
    """A block from a dict of columns or a list of rows."""
    if isinstance(batch, dict):
        block = {k: _as_column(v) for k, v in batch.items()}
        if len({len(v) for v in block.values()}) > 1:
            raise ValueError("a block's columns must have equal lengths, "
                             f"got {[(k, len(v)) for k, v in block.items()]}")
        return block
    if isinstance(batch, (list, np.ndarray)):
        return from_rows(list(batch))
    raise TypeError(f"unsupported batch type: {type(batch)}")


def to_batch(block: Block, batch_format: str = "numpy") -> Dict[str, Any]:
    """The block as a batch: "numpy" (or "default", None) gives its columns
    as a new dict."""
    if batch_format in ("numpy", "default", None):
        return dict(block)
    if batch_format in ("pandas", "pyarrow", "arrow"):
        raise ValueError(
            f"batch_format {batch_format!r} is not supported: the port's "
            "blocks are numpy columns, and it imports neither pandas nor "
            "pyarrow; use 'numpy'")
    raise ValueError(f"unknown batch_format: {batch_format!r}")


def rows_of(block: Block) -> Iterator[Dict[str, Any]]:
    """Each row as a dict: Python values from 1-d columns, an ndarray of
    the trailing shape from a multi-dim one."""
    cols = {k: v if v.ndim > 1 else v.tolist() for k, v in block.items()}
    for i in range(num_rows(block)):
        yield {k: col[i] for k, col in cols.items()}


def to_pylist(block: Block) -> List[Dict[str, Any]]:
    """Each row as Arrow's ``Table.to_pylist`` gives the JAX package's
    block: Python values, a multi-dim column's value as the flat list of
    its trailing elements (a fixed-size list)."""
    cols = {k: (v.reshape(len(v), -1).tolist() if v.ndim > 1
                else v.tolist()) for k, v in block.items()}
    return [{k: col[i] for k, col in cols.items()}
            for i in range(num_rows(block))]


def from_arrow(table) -> Block:
    """A block from a pyarrow table: numeric columns without nulls as
    their numpy arrays, a fixed-size list carrying the JAX package's
    ``np_shape`` field metadata as the multi-dim array it records, and any
    other column as ``from_batch`` makes it from the column's Python
    values (strings, bytes, lists, None for a null)."""
    import pyarrow as pa

    out: Block = {}
    for field, col in zip(table.schema, table.columns):
        meta = field.metadata or {}
        if (b"np_shape" in meta and pa.types.is_fixed_size_list(field.type)
                and col.null_count == 0):
            shape = json.loads(meta[b"np_shape"].decode())
            flat = col.combine_chunks().flatten().to_numpy(
                zero_copy_only=False)
            out[field.name] = flat.reshape([len(col)] + shape)
            continue
        if col.null_count == 0 and (pa.types.is_integer(field.type)
                                    or pa.types.is_floating(field.type)
                                    or pa.types.is_boolean(field.type)):
            out[field.name] = col.to_numpy()
            continue
        values = col.to_pylist()
        out[field.name] = (_as_column(values) if values
                           else np.asarray(values, dtype=object))
    return out


def to_arrow(block: Block):
    """A pyarrow table from a block, laid out as the JAX package's
    ``from_batch`` lays out a dict of columns: a multi-dim column as a
    fixed-size list with its trailing shape in the field's ``np_shape``
    metadata, every other column as ``pa.array`` of it."""
    import pyarrow as pa

    arrays, fields = [], []
    for k, v in block.items():
        if v.ndim > 1:
            inner = int(np.prod(v.shape[1:]))
            flat = pa.array(np.ascontiguousarray(v).reshape(-1))
            arr = pa.FixedSizeListArray.from_arrays(flat, inner)
            fields.append(pa.field(k, arr.type, metadata={
                b"np_shape": json.dumps(list(v.shape[1:])).encode()}))
        else:
            arr = pa.array(v.tolist() if v.dtype == object else v)
            fields.append(pa.field(k, arr.type))
        arrays.append(arr)
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def _nulls(n: int) -> np.ndarray:
    return np.full(n, None, dtype=object)


def concat(blocks: List[Block]) -> Block:
    """The blocks' rows in order, in one block.  Its columns are the union
    of the blocks' in the order first seen; a block that lacks one gives
    None there, as Arrow's promoting concat gives nulls."""
    blocks = [b for b in blocks if num_rows(b) > 0] or blocks[:1]
    if not blocks:
        return {}
    if len(blocks) == 1:
        return blocks[0]
    names: Dict[str, None] = {}
    for b in blocks:
        names.update(dict.fromkeys(b))
    return {k: np.concatenate([b[k] if k in b else _nulls(num_rows(b))
                               for b in blocks]) for k in names}


def slice_block(block: Block, start: int, stop: int) -> Block:
    """Rows ``start:stop`` of ``block`` (views)."""
    return {k: v[start:stop] for k, v in block.items()}


def take(block: Block, idx) -> Block:
    """The rows at ``idx`` (integer indices or a boolean mask), copied."""
    return {k: v[idx] for k, v in block.items()}


def split_by_bytes(block: Block, target_bytes: int) -> List[Block]:
    """Slice an oversized output block to ~target_bytes chunks (Ray: map
    tasks yield blocks bounded by target_max_block_size)."""
    n, nbytes = num_rows(block), size_bytes(block)
    if n == 0 or nbytes <= target_bytes:
        return [block]
    per_row = max(1, nbytes // max(1, n))
    rows_per = max(1, target_bytes // per_row)
    return [slice_block(block, i, min(i + rows_per, n))
            for i in range(0, n, rows_per)]


def empty_like(block: Optional[Block]) -> Block:
    """No rows, ``block``'s columns."""
    if block is None:
        return {}
    return {k: v[:0] for k, v in block.items()}
