"""The port's data iterator and in-process Dataset on the CPU.

Against the JAX package's runtime-free functions on pyarrow blocks built
from the same numpy columns: batching of ragged blocks, the local shuffle's
permutations, ``to_batch`` / ``rows_of``, and the constructors' block
layouts.  In the port alone: an upstream error reaches the consumer, an
early ``break`` stops the feed threads, ``iter_torch_batches`` on the CPU
applies ``dtypes`` and never falls back from CUDA, ``streaming_split``
deals blocks round-robin, and a shard pickles.
"""

import pickle
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu.data import block as jblock
from ray_tpu.data import datasource as jsource
from ray_tpu.data import iterator as jiter
from ray_tpu_torch import data
from ray_tpu_torch.data import block as tblock
from ray_tpu_torch.data import iterator as titer

SIZES = (5, 0, 3, 9, 1, 6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        got = list(data.range(n, override_num_blocks=par)._blocks)
        _assert_batches_equal(want, got)
    items = [{"a": i, "b": float(i) / 2} for i in range(11)]
    want = [jblock.to_batch(b) for task in jsource.items_tasks(items, 4)
            for b in task()]
    got = list(data.from_items(items, override_num_blocks=4)._blocks)
    _assert_batches_equal(want, got)
    arr = np.arange(24, dtype=np.int32).reshape(4, 6)
    want = jblock.to_batch(jblock.from_batch({"tokens": arr}))
    (got,) = data.from_numpy(arr, column="tokens")._blocks
    _assert_batches_equal([want], [got])


def test_iter_batches_and_rows():
    ds = data.Dataset([tblock.from_batch(c) for c in _columns()])
    got = list(ds.iter_batches(batch_size=4, drop_last=True,
                               local_shuffle_buffer_size=8,
                               local_shuffle_seed=1))
    assert [len(b["id"]) for b in got] == [4] * (sum(SIZES) // 4)
    rows = list(ds.iter_rows())
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
    """Block i goes to shard i % n, as the JAX package's split coordinator
    deals its bundles."""
    ds = data.range(20, override_num_blocks=7)
    blocks = [b["id"].tolist() for b in ds._blocks]
    shards = ds.streaming_split(3)
    for r, shard in enumerate(shards):
        got = [b["id"].tolist() for b in
               shard.iter_batches(batch_size=None)]
        assert got == [b for i, b in enumerate(blocks) if i % 3 == r]
    with pytest.raises(ValueError):
        ds.streaming_split(0)


def test_a_shard_pickles():
    ds = data.from_numpy(np.arange(30).reshape(10, 3), column="tokens")
    (shard,) = ds.streaming_split(1)
    assert isinstance(shard, data.DataIterator)
    copy = pickle.loads(pickle.dumps(shard))
    want = [b["tokens"] for b in shard.iter_batches(batch_size=4)]
    got = [b["tokens"] for b in copy.iter_batches(batch_size=4)]
    _assert_batches_equal([{"t": np.concatenate(want)}],
                          [{"t": np.concatenate(got)}])
