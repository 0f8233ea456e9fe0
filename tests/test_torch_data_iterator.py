"""The port's data iterator on the CPU.

Against the JAX package's runtime-free functions on pyarrow blocks built
from the same numpy columns: batching of ragged blocks, the local shuffle's
permutations, ``to_batch`` / ``rows_of``, and the constructors' block
layouts.  In the port alone, over (ref, meta) bundles in the port's
runtime's store (a module fixture starts it): an upstream error reaches
the consumer, an early ``break`` stops the feed threads,
``iter_torch_batches`` on the CPU applies ``dtypes`` and never falls back
from CUDA, ``streaming_split``'s coordinator deals blocks round-robin, a
shard pickles into another process, and a plan of more than 1 MB reaches
a fresh coordinator through the store.
"""

import pickle
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest
import torch

from ray_tpu.data import block as jblock
from ray_tpu.data import datasource as jsource
from ray_tpu.data import iterator as jiter
from ray_tpu_torch import data
from ray_tpu_torch.data import block as tblock
from ray_tpu_torch.data import iterator as titer

# the task that reads a pickled shard runs in a worker that cannot import
# this module: pickle it by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

SIZES = (5, 0, 3, 9, 1, 6)
TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the worker processes
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def runtime(one_thread):
    import ray_tpu_torch as rt

    rt.init(num_cpus=4, min_workers=2, object_store_memory=1 << 28)
    try:
        yield rt
    finally:
        rt.shutdown()


def _bundles(blocks):
    import ray_tpu_torch as rt

    return [(rt.put(b), tblock.BlockMetadata.of(b)) for b in blocks]


def _blocks_of(ds):
    """The dataset's blocks, in order, out of the store."""
    import ray_tpu_torch as rt

    return [rt.get(ref, timeout=TIMEOUT) for ref, _ in ds.iter_bundles()]


def _columns():
    """Ragged blocks' columns: an int id, a float, and a (n, 2, 3) array."""
    rng = np.random.default_rng(3)
    out, start = [], 0
    for n in SIZES:
        out.append({"id": np.arange(start, start + n, dtype=np.int64),
                    "x": rng.standard_normal(n).astype(np.float32),
                    "v": rng.standard_normal((n, 2, 3))})
        start += n
    return out


def _both():
    cols = _columns()
    return ([jblock.from_batch(c) for c in cols],
            [tblock.from_batch(c) for c in cols])


def _assert_batches_equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert list(w) == list(g)
        for k in w:
            assert w[k].dtype == g[k].dtype and w[k].shape == g[k].shape, k
            np.testing.assert_array_equal(w[k], g[k])


@pytest.mark.parametrize("batch_size,drop_last",
                         [(4, False), (4, True), (7, True), (None, False),
                          (100, False)])
def test_batch_blocks_matches_jax(batch_size, drop_last):
    jb, tb = _both()
    want = [jblock.to_batch(b) for b in
            jiter._batch_blocks(iter(jb), batch_size, drop_last)]
    got = [tblock.to_batch(b) for b in
           titer._batch_blocks(iter(tb), batch_size, drop_last)]
    _assert_batches_equal(want, got)


@pytest.mark.parametrize("buffer_rows,seed", [(4, 0), (10, 7), (64, None)])
def test_shuffled_matches_jax(buffer_rows, seed):
    """The same permutations for the same seed (with None each side draws
    its own, so only the rows' multiset is compared)."""
    jb, tb = _both()
    want = [jblock.to_batch(b) for b in
            jiter._shuffled(iter(jb), buffer_rows, seed)]
    got = [tblock.to_batch(b) for b in
           titer._shuffled(iter(tb), buffer_rows, seed)]
    if seed is None:
        assert sorted(np.concatenate([b["id"] for b in got])) == list(
            range(sum(SIZES)))
        return
    _assert_batches_equal(want, got)


def test_to_batch_and_rows_of_match_jax():
    jb, tb = _both()
    for j, t in zip(jb, tb):
        _assert_batches_equal([jblock.to_batch(j)], [tblock.to_batch(t)])
        want, got = list(jblock.rows_of(j)), list(tblock.rows_of(t))
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert list(w) == list(g)
            assert w["id"] == g["id"] and type(w["id"]) is type(g["id"])
            assert w["x"] == g["x"]
            np.testing.assert_array_equal(w["v"], g["v"])
    for fmt in ("pandas", "pyarrow"):
        with pytest.raises(ValueError, match="numpy"):
            tblock.to_batch(tb[0], fmt)
    with pytest.raises(ValueError, match="unknown batch_format"):
        tblock.to_batch(tb[0], "tensorflow")


def test_constructors_match_jax_block_layouts():
    """``range`` and ``from_items`` cut their blocks as the JAX package's
    read tasks do; ``from_numpy`` is one block of the array."""
    for n, par in ((10, 3), (7, 8), (0, 4)):
        want = [jblock.to_batch(b) for task in jsource.range_tasks(n, par)
                for b in task()]
        got = _blocks_of(data.range(n, override_num_blocks=par))
        _assert_batches_equal(want, got)
    items = [{"a": i, "b": float(i) / 2} for i in range(11)]
    want = [jblock.to_batch(b) for task in jsource.items_tasks(items, 4)
            for b in task()]
    got = _blocks_of(data.from_items(items, override_num_blocks=4))
    _assert_batches_equal(want, got)
    arr = np.arange(24, dtype=np.int32).reshape(4, 6)
    want = jblock.to_batch(jblock.from_batch({"tokens": arr}))
    (got,) = _blocks_of(data.from_numpy(arr, column="tokens"))
    _assert_batches_equal([want], [got])


def test_iter_batches_and_rows():
    it = data.DataIterator(_bundles([tblock.from_batch(c)
                                     for c in _columns()]))
    got = list(it.iter_batches(batch_size=4, drop_last=True,
                               local_shuffle_buffer_size=8,
                               local_shuffle_seed=1))
    assert [len(b["id"]) for b in got] == [4] * (sum(SIZES) // 4)
    rows = list(it.iter_rows())
    assert [r["id"] for r in rows] == list(range(sum(SIZES)))
    assert rows[3]["v"].shape == (2, 3)


def test_prefetched_raises_the_upstream_error_in_the_consumer():
    def upstream():
        yield 1
        yield 2
        raise KeyError("bad block")

    it = titer._prefetched(upstream(), 1)
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(KeyError, match="bad block"):
        next(it)


def _feed_threads():
    return [t for t in threading.enumerate()
            if t.name == titer.FEED_THREAD and t.is_alive()]


@pytest.mark.parametrize("path", ["iter_batches", "iter_torch_batches"])
def test_an_early_break_stops_the_feed_threads(path):
    """The consumer takes one batch of many and leaves the loop; every feed
    thread (the batches' and any upstream one) ends within 2 s."""
    assert not _feed_threads()
    ds = data.range(10_000, override_num_blocks=50)
    kw = {"device": "cpu"} if path == "iter_torch_batches" else {}
    for _ in getattr(ds, path)(batch_size=8, prefetch_batches=1, **kw):
        assert _feed_threads()
        break
    deadline = time.monotonic() + 2.0
    while _feed_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _feed_threads()


def test_iter_torch_batches_on_the_cpu_applies_dtypes():
    ds = data.from_items([{"a": i, "b": i / 4} for i in range(10)],
                         override_num_blocks=3)
    one = list(ds.iter_torch_batches(batch_size=4, dtypes=torch.float16,
                                     device="cpu"))
    assert [b["a"].dtype for b in one] == [torch.float16] * 3
    assert [len(b["a"]) for b in one] == [4, 4, 2]
    by_col = next(iter(ds.iter_torch_batches(
        batch_size=4, dtypes={"b": torch.float32}, device="cpu")))
    assert by_col["a"].dtype == torch.int64
    assert by_col["b"].dtype == torch.float32
    assert by_col["b"].tolist() == [0.0, 0.25, 0.5, 0.75]
    dropped = list(ds.iter_torch_batches(batch_size=4, drop_last=True,
                                         device="cpu"))
    assert len(dropped) == 2


def test_iter_torch_batches_onto_cuda_raises_without_it(monkeypatch):
    """No fallback: asked for CUDA where there is none, it raises instead
    of yielding CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        data.range(8).iter_torch_batches(batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        data.range(8).iter_torch_batches(batch_size=4, device="cuda:0")


def test_streaming_split_deals_blocks_round_robin():
    """Block i goes to shard i % n, dealt by one coordinator actor in the
    order the JAX package's deals its bundles."""
    ds = data.range(20, override_num_blocks=7)
    blocks = [b["id"].tolist() for b in _blocks_of(ds)]
    shards = ds.streaming_split(3)
    for r, shard in enumerate(shards):
        got = [b["id"].tolist() for b in
               shard.iter_batches(batch_size=None)]
        assert got == [b for i, b in enumerate(blocks) if i % 3 == r]
    with pytest.raises(ValueError):
        ds.streaming_split(0)


def _read_shard(shard):
    return np.concatenate([b["tokens"]
                           for b in shard.iter_batches(batch_size=4)])


def test_a_shard_pickles():
    """A shard pickles (the trainer sends shards to its workers) and
    reads its coordinator's rows in another process."""
    import ray_tpu_torch as rt

    arr = np.arange(30).reshape(10, 3)
    ds = data.from_numpy(arr, column="tokens")
    (shard,) = ds.streaming_split(1)
    assert isinstance(shard, data.DataIterator)
    copy = pickle.loads(pickle.dumps(shard))
    got = rt.get(rt.remote(_read_shard).remote(copy), timeout=TIMEOUT)
    _assert_batches_equal([{"t": arr}], [{"t": got}])


class _Recorder:
    """Stands in for a module's ``cloudpickle``: records the size of every
    blob it makes."""

    def __init__(self, sizes):
        self._sizes = sizes

    def dumps(self, obj, *a, **k):
        blob = cloudpickle.dumps(obj, *a, **k)
        self._sizes.append(len(blob))
        return blob

    def __getattr__(self, name):
        return getattr(cloudpickle, name)


def test_a_plan_of_more_than_a_megabyte_reaches_a_fresh_coordinator(
        monkeypatch):
    """The native transport drops a new worker that reads nothing for 10 s
    (ROADMAP.md, faults ported as they are), so nothing large may reach a
    new actor inline: the coordinator's plan (here 1.3 MB of rows inside
    its read tasks) and an actor pool's UDF go through the store, and so
    do read tasks that hold their rows.  Every actor creation and task
    this process sends stays under the executor's ``INLINE_MAX``; the
    rows arrive."""
    from ray_tpu_torch.core import actor, remote_function
    from ray_tpu_torch.data import executor

    rng = np.random.default_rng(8)
    rows = [{"i": i, "x": rng.standard_normal(2048)} for i in range(80)]
    ds = data.from_items(rows, override_num_blocks=4)
    assert len(cloudpickle.dumps(ds._plan)) > 1 << 20
    sizes = []
    for mod in (actor, remote_function):
        monkeypatch.setattr(mod, "cloudpickle", _Recorder(sizes))
    shards = ds.streaming_split(2)
    got = {}
    for shard in shards:
        for b in shard.iter_batches(batch_size=None):
            got.update(zip(b["i"].tolist(), b["x"]))
    assert ds.count() == len(rows)  # read tasks sent from this process
    pool = ds.map_batches(lambda b, big: b, fn_kwargs={"big": rows},
                          compute="actors", concurrency=1)
    assert pool.count() == len(rows)
    monkeypatch.undo()
    assert sorted(got) == list(range(len(rows)))
    for r in rows:
        np.testing.assert_array_equal(got[r["i"]], r["x"])
    assert sizes and max(sizes) < executor.INLINE_MAX, sorted(sizes)[-3:]
