"""Blocks: the unit of data movement, a dict of equal-length numpy columns.

Counterpart of ``ray_tpu/data/block.py``, whose block is a pyarrow Table.
The port's runs where there is no pyarrow (the GPU machine has none), so a
block is ``{column: ndarray}``: a multi-dim column (token rows, images)
keeps its trailing shape as it is, where the JAX package stores a
fixed-size list with the shape in the field's metadata.  The batch format
is "numpy"; "pandas" and "pyarrow" raise.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List

import numpy as np

Block = Dict[str, np.ndarray]

# Column name used when data has no schema (a range of ints, a list of
# scalars), as in the JAX package
VALUE_COL = "item"


def num_rows(block: Block) -> int:
    """The rows of ``block`` (0 for a block with no column)."""
    return len(next(iter(block.values()))) if block else 0


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


def from_batch(batch: Any) -> Block:
    """A block from a dict of columns or a list of rows."""
    if isinstance(batch, dict):
        block = {k: np.asarray(v) for k, v in batch.items()}
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


def concat(blocks: List[Block]) -> Block:
    """The blocks' rows in order, in one block."""
    blocks = [b for b in blocks if num_rows(b) > 0] or blocks[:1]
    if not blocks:
        return {}
    if len(blocks) == 1:
        return blocks[0]
    return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}


def slice_block(block: Block, start: int, stop: int) -> Block:
    """Rows ``start:stop`` of ``block`` (views)."""
    return {k: v[start:stop] for k, v in block.items()}
