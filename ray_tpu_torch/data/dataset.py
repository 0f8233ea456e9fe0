"""An in-process Dataset of numpy blocks: what the train path needs.

Counterpart of the parts of ``ray_tpu/data/dataset.py`` and
``ray_tpu/data/split.py`` that a train loop reads through.  The JAX
package's Dataset is a lazy plan executed on its runtime; the port has no
runtime, so a Dataset holds its blocks (``data/block.py``) in memory, in
the layout the JAX package's constructors give them (``data/__init__.py``).
``streaming_split`` deals the blocks round-robin to n ``DataIterator``s in
the order the JAX package's split coordinator deals its bundles.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.iterator import DataIterator


def _chunk(items: List[Any], n: int) -> List[List[Any]]:
    """``items`` in ``n`` contiguous groups, the first ``len % n`` one
    longer (empty groups dropped): the JAX package's ``from_items``
    blocks."""
    n = max(1, min(n, len(items)))
    size, rem = divmod(len(items), n)
    out, i = [], 0
    for k in range(n):
        take = size + (1 if k < rem else 0)
        if take:
            out.append(items[i:i + take])
        i += take
    return out


class Dataset:
    def __init__(self, blocks: List[Block]):
        self._blocks = list(blocks)

    def iterator(self) -> DataIterator:
        return DataIterator(self._blocks)

    def iter_batches(self, **kw) -> Iterator[Any]:
        return self.iterator().iter_batches(**kw)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        return self.iterator().iter_rows()

    def iter_torch_batches(self, **kw) -> Iterator[Dict[str, Any]]:
        return self.iterator().iter_torch_batches(**kw)

    def streaming_split(self, n: int) -> List[DataIterator]:
        """n shards: block i goes to shard i % n.  Each holds its blocks
        and nothing else, so it pickles."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        return [DataIterator(self._blocks[i::n]) for i in range(n)]

    def __repr__(self):
        return f"Dataset(num_blocks={len(self._blocks)})"
