"""Data: in-process datasets of numpy blocks and the iterator a train loop
reads them through.

Counterpart of the part of ``ray_tpu.data`` the train path uses: the
constructors ``range``, ``from_items`` and ``from_numpy`` with the JAX
package's block layouts, ``Dataset`` with its ``streaming_split``, and
``DataIterator`` with ``iter_torch_batches`` onto the GPU.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import numpy as np

from ray_tpu_torch.data import block as _block
from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.dataset import Dataset, _chunk
from ray_tpu_torch.data.iterator import DataIterator


def _par(override: Optional[int]) -> int:
    """Blocks of a read: the override, else the JAX package's
    ``DataContext.default_parallelism``."""
    return override or max(4, os.cpu_count() or 4)


def range(n: int, *,  # noqa: A001 — the JAX package's name
          override_num_blocks: Optional[int] = None) -> Dataset:
    """Rows ``{"id": i}`` for i in [0, n), int64, in evenly split blocks."""
    bounds = np.linspace(0, n, max(1, min(_par(override_num_blocks),
                                          n or 1)) + 1, dtype=np.int64)
    return Dataset([{"id": np.arange(lo, hi, dtype=np.int64)}
                    for lo, hi in zip(bounds[:-1], bounds[1:])])


def from_items(items: List[Any], *,
               override_num_blocks: Optional[int] = None) -> Dataset:
    """One row per item (dicts by key, anything else as ``"item"``)."""
    return Dataset([_block.from_rows(group) for group in
                    _chunk(list(items), _par(override_num_blocks))])


def from_numpy(arr, column: str = "item") -> Dataset:
    """One block holding ``arr`` as one column, its rows along axis 0."""
    return Dataset([_block.from_batch({column: np.asarray(arr)})])


__all__ = ["Block", "DataIterator", "Dataset", "from_items", "from_numpy",
           "range"]
