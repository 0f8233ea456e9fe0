"""DataIterator: batched consumption with prefetch and the copy onto the GPU.

Counterpart of ``ray_tpu/data/iterator.py``: slices a stream of blocks
into fixed-size batches, with an optional local shuffle buffer and
background prefetch.  The JAX package fetches each block from its object
store; the port has no store, and its source is any re-runnable iterable
of numpy blocks (``data/block.py``), such as the list a ``Dataset`` shard
holds.  ``iter_torch_batches`` onto a CUDA device is the counterpart of
``iter_jax_batches``: each batch is staged in pinned host memory and
copied without blocking on a side stream, two batches in flight, so the
copy of batch N+1 overlaps the step on batch N; the consumer's stream
waits on a batch's copy before it receives the batch.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block

FEED_THREAD = "ray_tpu_torch-data-feed"


def _batch_blocks(blocks: Iterator[Block], batch_size: Optional[int],
                  drop_last: bool) -> Iterator[Block]:
    if batch_size is None:
        yield from (b for b in blocks if block_mod.num_rows(b))
        return
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
    if buf and not drop_last:
        yield block_mod.concat(buf)


def _shuffled(blocks: Iterator[Block], buffer_rows: int,
              seed: Optional[int]) -> Iterator[Block]:
    """Local shuffle buffer: the same permutations as the JAX package's
    for the same seed and blocks."""
    rng = np.random.default_rng(seed)
    buf: List[Block] = []
    have = 0
    for b in blocks:
        buf.append(b)
        have += block_mod.num_rows(b)
        if have >= buffer_rows:
            tbl = block_mod.concat(buf)
            perm = rng.permutation(block_mod.num_rows(tbl))
            yield {k: v[perm] for k, v in tbl.items()}
            buf, have = [], 0
    if buf:
        tbl = block_mod.concat(buf)
        perm = rng.permutation(block_mod.num_rows(tbl))
        yield {k: v[perm] for k, v in tbl.items()}


def _prefetched(it: Iterator, depth: int) -> Iterator:
    """Run the upstream iterator on a thread, keep ``depth`` items ready.
    The feed thread watches a stop flag so an abandoned consumer (an early
    ``break`` from a train loop) releases the upstream pipeline instead of
    blocking forever on a full queue; it closes the upstream iterator as
    it ends, so a chain of these stops link by link."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
    DONE, ERR = object(), object()
    stop = threading.Event()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def feed():
        try:
            for item in it:
                if not offer(item):
                    return
            offer(DONE)
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            offer((ERR, e))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=feed, name=FEED_THREAD, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                return
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] is ERR):
                raise item[1]
            yield item
    finally:
        stop.set()


def _to_tensors(batch: Dict[str, np.ndarray], dtypes) -> Dict[str, Any]:
    """A numpy batch as CPU tensors with ``dtypes`` applied (one dtype for
    every column, or a dict by column)."""
    import torch

    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if dtypes is not None:
            t = t.to(dtypes if not isinstance(dtypes, dict)
                     else dtypes.get(k, t.dtype))
        out[k] = t
    return out


class CudaBatch(dict):
    """A batch of CUDA tensors by column.  ``copied`` is the event of its
    host-to-device copy, recorded with timing on the copy's stream."""

    copied: Any = None


class _PinnedCopies:
    """The feed thread's half of the copy onto ``device``: two sets of
    pinned host buffers taken in turn, one side stream, and an event per
    copy.  A set is refilled only after its last copy has completed, so
    the source of a copy stays alive until the copy ends."""

    SLOTS = 2

    def __init__(self, device):
        import torch

        torch.cuda.set_device(device)  # the thread's device, then a stream
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots: List[Dict[str, Any]] = [{} for _ in range(self.SLOTS)]
        self.events: List[Any] = [None] * self.SLOTS
        self.n = 0

    def _pinned(self, slot: Dict[str, Any], key: str, t):
        import torch

        buf = slot.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = slot[key] = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
        return buf

    def copy(self, tensors: Dict[str, Any]) -> CudaBatch:
        import torch

        i = self.n % self.SLOTS
        self.n += 1
        if self.events[i] is not None:
            self.events[i].synchronize()
        slot = self.slots[i]
        out = CudaBatch()
        with torch.cuda.stream(self.stream):
            for k, t in tensors.items():
                buf = self._pinned(slot, k, t)
                buf.copy_(t)
                out[k] = torch.empty(t.shape, dtype=t.dtype,
                                     device=self.device)
                out[k].copy_(buf, non_blocking=True)
            event = torch.cuda.Event(enable_timing=True)
            event.record(self.stream)
        self.events[i] = out.copied = event
        return out


class DataIterator:
    """Batches from a re-runnable iterable of blocks.  Holds only the
    source until it is iterated, so a shard of numpy blocks pickles (the
    trainer sends shards to its workers)."""

    def __init__(self, blocks: Iterable[Block]):
        self._source = blocks

    def _blocks(self) -> Iterator[Block]:
        return iter(self._source)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_batches: int = 2) -> Iterator[Any]:
        blocks = self._blocks()
        if local_shuffle_buffer_size:
            blocks = _shuffled(blocks, local_shuffle_buffer_size,
                               local_shuffle_seed)
        batches = _batch_blocks(blocks, batch_size, drop_last)
        out = (block_mod.to_batch(b, batch_format) for b in batches)
        if prefetch_batches and prefetch_batches > 0:
            out = _prefetched(out, prefetch_batches)
        return out

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for b in self._blocks():
            yield from block_mod.rows_of(b)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           dtypes=None, device=None,
                           **kw) -> Iterator[Dict[str, Any]]:
        """Batches as dicts of tensors on ``device`` (CUDA unless
        ``device="cpu"``; raises where CUDA is missing), ``dtypes`` applied
        (one dtype, or a dict by column), ``kw`` passed to
        ``iter_batches``.  On the CPU each batch is converted as it comes.
        On CUDA each is staged in pinned memory and copied on a side
        stream ahead of the consumer (module docstring): the batch is a
        ``CudaBatch``, its tensors recorded on the consumer's stream, which
        waits on the copy's event."""
        import torch

        dev = resolve_device(device)
        host = self.iter_batches(batch_size=batch_size,
                                 batch_format="numpy", **kw)
        if dev.type != "cuda":
            return ({k: t.to(dev) for k, t in
                     _to_tensors(b, dtypes).items()} for b in host)
        if dev.index is None:  # the caller's device, for the feed thread
            dev = torch.device("cuda", torch.cuda.current_device())
        return _consumed(_prefetched(_copied(host, dev, dtypes), 2), dev)


def _copied(host: Iterator, device, dtypes) -> Iterator[CudaBatch]:
    """Runs on the feed thread: each host batch copied onto ``device``."""
    copies = _PinnedCopies(device)
    for batch in host:
        yield copies.copy(_to_tensors(batch, dtypes))


def _consumed(batches: Iterator[CudaBatch], device) -> Iterator[CudaBatch]:
    """The consumer's half: its stream waits on each batch's copy, and each
    tensor is recorded on that stream so the allocator does not reuse its
    memory before the consumer's work on it ends."""
    import torch

    try:
        for batch in batches:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(batch.copied)
            for t in batch.values():
                t.record_stream(stream)
            yield batch
    finally:
        batches.close()  # stops the feed thread after an early break
