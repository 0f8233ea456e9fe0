"""DataIterator: batched consumption with prefetch and the copy onto the GPU.

Counterpart of ``ray_tpu/data/iterator.py`` (Ray's python/ray/data/
iterator.py, _internal/block_batching/iter_batches.py): slices a stream of
(block_ref, metadata) bundles into fixed-size batches, fetching each block
from the store three ahead on a feed thread, with an optional local
shuffle buffer and background prefetch.  The source is any re-runnable
iterable of bundles: a dataset's plan (``_BundleIterable``) or one shard
of a ``streaming_split`` (``split.ShardIterable``).  ``iter_torch_batches``
onto a CUDA device is the counterpart of ``iter_jax_batches``: each batch
is staged in pinned host memory and copied without blocking on a side
stream, two batches in flight, so the copy of batch N+1 overlaps the step
on batch N; the consumer's stream waits on a batch's copy before it
receives the batch.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block

FEED_THREAD = "ray_tpu_torch-data-feed"


class _BundleIterable:
    """Re-runnable source of (ref, meta) bundles from a dataset plan."""

    def __init__(self, make_iter: Callable[[], Iterator]):
        self._make_iter = make_iter

    def __iter__(self):
        return self._make_iter()


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
    """Batches from a re-runnable iterable of (ref, meta) bundles.  Holds
    only the source until it is iterated, so a shard pickles (the trainer
    sends shards to its workers)."""

    def __init__(self, bundles: Any):
        self._bundles = bundles

    def _blocks(self) -> Iterator[Block]:
        # Fetch on a feed thread with a small window so the NEXT block's
        # store get overlaps consumption of the current one.
        def fetch():
            for ref, _meta in self._bundles:
                yield rt.get(ref)

        return _prefetched(fetch(), 3)

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

        from ray_tpu_torch._device import resolve_device

        dev = resolve_device(device)
        host = self.iter_batches(batch_size=batch_size,
                                 batch_format="numpy", **kw)
        if dev.type != "cuda":
            return ({k: t.to(dev) for k, t in
                     _to_tensors(b, dtypes).items()} for b in host)
        if dev.index is None:  # the caller's device, for the feed thread
            dev = torch.device("cuda", torch.cuda.current_device())
        return _consumed(_prefetched(_copied(host, dev, dtypes), 2), dev)

    def iter_jax_batches(self, **kw):
        raise NotImplementedError(
            "iter_jax_batches: the port has no JAX; use iter_torch_batches")

    @staticmethod
    def _densify(v):
        """Object columns (variable-length lists) -> stacked dense arrays
        (tf rejects object dtype)."""
        arr = np.asarray(v)
        if arr.dtype == object:
            try:
                return np.stack([np.asarray(x) for x in arr])
            except ValueError:
                return arr  # genuinely ragged: caller's problem
        return arr

    def iter_tf_batches(self, *, batch_size: Optional[int] = 256,
                        **kw) -> Iterator[Any]:
        """numpy batches as dicts of tf.Tensors (Ray's
        iterator.iter_tf_batches).  tensorflow is imported here, on the
        call: the card's host has none, and the data package imports it
        nowhere else."""
        import tensorflow as tf

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy", **kw):
            yield {k: tf.convert_to_tensor(self._densify(v))
                   for k, v in batch.items()}

    def to_tf(self, feature_columns, label_columns, *,
              batch_size: int = 256, **kw):
        """A tf.data.Dataset of (features, labels) (Ray's dataset.to_tf).
        Column args may be a name or a list of names; the signature comes
        from a probe batch of two rows."""
        import tensorflow as tf

        feats = ([feature_columns] if isinstance(feature_columns, str)
                 else list(feature_columns))
        labels = ([label_columns] if isinstance(label_columns, str)
                  else list(label_columns))

        def pick(batch, cols):
            if len(cols) == 1:
                return self._densify(batch[cols[0]])
            return {c: self._densify(batch[c]) for c in cols}

        try:
            probe = next(iter(self.iter_batches(
                batch_size=2, batch_format="numpy", **kw)))
        except StopIteration:
            raise ValueError(
                "to_tf: dataset is empty (no batches to infer the "
                "tf.TensorSpec from)") from None
        probe = {k: self._densify(v) for k, v in probe.items()}

        def spec_of(cols):
            if len(cols) == 1:
                v = probe[cols[0]]
                return tf.TensorSpec(
                    shape=(None,) + v.shape[1:], dtype=v.dtype)
            return {c: tf.TensorSpec(shape=(None,) + probe[c].shape[1:],
                                     dtype=probe[c].dtype) for c in cols}

        def gen():
            for batch in self.iter_batches(batch_size=batch_size,
                                           batch_format="numpy", **kw):
                yield pick(batch, feats), pick(batch, labels)

        return tf.data.Dataset.from_generator(
            gen, output_signature=(spec_of(feats), spec_of(labels)))

    def materialize(self):
        from ray_tpu_torch.data import logical as L
        from ray_tpu_torch.data.dataset import MaterializedDataset

        bundles = list(self._bundles)
        return MaterializedDataset(
            L.LogicalPlan([L.InputData(name="Input", bundles=bundles)]),
            bundles)


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
