"""Datasources: the read tasks behind the constructors.

Counterpart of the part of ``ray_tpu/data/datasource.py`` that
``range`` and ``from_items`` use (Ray's python/ray/data/read_api.py): a
read is a list of zero-arg callables, each yielding numpy blocks,
scheduled as ordinary tasks by the streaming executor.  The file readers,
the connectors and the writes are not ported yet; they come with the data
package's sources in a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List

import numpy as np

from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block


def _chunk(items: List[Any], n: int) -> List[List[Any]]:
    """``items`` in ``n`` contiguous groups, the first ``len % n`` one
    longer (empty groups dropped)."""
    n = max(1, min(n, len(items)))
    size, rem = divmod(len(items), n)
    out, i = [], 0
    for k in range(n):
        take = size + (1 if k < rem else 0)
        if take:
            out.append(items[i:i + take])
        i += take
    return out


def range_tasks(n: int, parallelism: int) -> List[Callable]:
    """``data.range``: an int64 column "id" like Ray's read_api.range."""
    tasks = []
    bounds = np.linspace(0, n, max(1, min(parallelism, n or 1)) + 1,
                         dtype=np.int64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        lo_i, hi_i = int(lo), int(hi)

        def read(lo=lo_i, hi=hi_i) -> Iterator[Block]:
            yield {"id": np.arange(lo, hi, dtype=np.int64)}

        tasks.append(read)
    return tasks


def items_tasks(items: List[Any], parallelism: int) -> List[Callable]:
    tasks = []
    for group in _chunk(list(items), parallelism):
        def read(group=group) -> Iterator[Block]:
            yield block_mod.from_rows(group)

        tasks.append(read)
    return tasks
