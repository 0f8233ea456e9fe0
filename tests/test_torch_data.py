"""The port's data plane (``ray_tpu_torch.data``) held to the JAX package's.

Every case of ``tests/test_data.py`` that needs no file reader, pandas or
pyarrow I/O, and the join, actor-pool autoscaling and backpressure cases
of ``tests/test_data_extras.py``, is written once as a function of the
package under test.  It runs under the JAX package's session cluster
(``ray_cluster``) and under the port's runtime, started by a module
fixture in the same process, makes its JAX test's assertions in both, and
returns what it read; the two results must be equal (the file readers and
writes are ``tests/test_torch_data_sources.py``'s).  Where JAX's row
order belongs to the host (groups, join output), the rows are sorted
first, as the JAX tests do.  A seeded ``random_shuffle`` gives JAX's rows
in JAX's order; ``std`` is Arrow's (ddof 0); nulls are None.  Each case
runs on a thread bounded by ``TIMEOUT`` s.
"""

import ast
import concurrent.futures
import sys
import threading
import types

import cloudpickle
import numpy as np
import pytest
import torch

# UDF classes and functions defined here run in worker processes that
# cannot import this module: pickle them by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 120

# the names of the JAX package's data/__init__.py that the port has yet to
# export (none: the connectors came last)
LATER = set()

# the functions of the data package that may import pyarrow, pandas or PIL
# (the readers and writes of the formats that need them), by file
LIBRARY_IMPORTS = {
    "__init__.py": {"from_pandas"},
    "block.py": {"from_arrow", "to_arrow"},
    "datasource.py": {"parquet_tasks.read_file", "csv_tasks.read_file",
                      "json_tasks.read_file", "image_tasks",
                      "image_tasks.read_group", "make_write_fn.write_blocks"},
    "lakehouse.py": {"iceberg_tasks.read_file"},
    "delta_sharing.py": {"_fetch_parquet"},
    "video.py": {"_decode_frame"},
}
# the functions that may import tensorflow: the TF feed's two
TF_IMPORTS = {"iterator.py": {"iter_tf_batches", "to_tf"}}

# the executor's metric families: "data_op_" + each suffix
METRIC_SUFFIXES = ("rows_total", "output_bytes_total", "tasks_total",
                   "backpressure_stalls_total")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the worker processes
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(ray_cluster, _one_torch_thread):
    import ray_tpu_torch as rt

    rt.init(min_workers=4, max_workers=8, object_store_memory=1 << 28,
            resources={"CPU": 8.0})
    yield rt
    rt.shutdown()


def _packages():
    import ray_tpu
    import ray_tpu.data
    import ray_tpu.data.backpressure
    import ray_tpu.util.metrics
    import ray_tpu_torch
    import ray_tpu_torch.data
    import ray_tpu_torch.data.backpressure
    import ray_tpu_torch.util.metrics

    return {"jax": types.SimpleNamespace(
                rt=ray_tpu, rd=ray_tpu.data, bp=ray_tpu.data.backpressure,
                ctx=ray_tpu.data.DataContext, metrics=ray_tpu.util.metrics),
            "torch": types.SimpleNamespace(
                rt=ray_tpu_torch, rd=ray_tpu_torch.data,
                bp=ray_tpu_torch.data.backpressure,
                ctx=ray_tpu_torch.data.DataContext,
                metrics=ray_tpu_torch.util.metrics)}


def test_exports_cover_jax_less_the_sources():
    import ray_tpu.data
    import ray_tpu_torch.data

    jax_names = set(ray_tpu.data.__all__)
    assert LATER <= jax_names
    assert jax_names - LATER == set(ray_tpu_torch.data.__all__)
    for name in ray_tpu_torch.data.__all__:
        assert getattr(ray_tpu_torch.data, name) is not None, name


def _imports_by_function(tree):
    """(dotted name of the enclosing function, or "" at module level,
    top-level package imported) for each import in ``tree``."""
    out = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, f"{scope}.{child.name}" if scope
                      else child.name)
                continue
            if isinstance(child, ast.Import):
                out.extend((scope, a.name.split(".")[0])
                           for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                out.append((scope, (child.module or "").split(".")[0]))
            visit(child, scope)

    visit(tree, "")
    return out


def test_nothing_in_the_data_package_imports_pyarrow():
    """pyarrow, pandas and PIL are imported only inside the functions of
    ``LIBRARY_IMPORTS`` (the card's host has none of them), never at a
    module's level; tensorflow only inside the TF feed's two functions
    (``TF_IMPORTS``)."""
    import pathlib

    import ray_tpu_torch.data

    root = pathlib.Path(ray_tpu_torch.data.__file__).parent
    seen, seen_tf = set(), set()
    for path in root.glob("*.py"):
        allowed = LIBRARY_IMPORTS.get(path.name, set())
        for scope, pkg in _imports_by_function(ast.parse(path.read_text())):
            if pkg == "tensorflow":
                assert scope in TF_IMPORTS.get(path.name, set()), \
                    (path, scope)
                seen_tf.add((path.name, scope))
            if pkg in ("pyarrow", "pandas", "PIL"):
                assert scope in allowed, (path, scope, pkg)
                seen.add((path.name, scope))
    assert seen == {(f, s) for f, names in LIBRARY_IMPORTS.items()
                    for s in names}
    assert seen_tf == {(f, s) for f, names in TF_IMPORTS.items()
                       for s in names}


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _ids(rows, key="id"):
    return [r[key] for r in rows]


# ---------------------------------------------------------------------------
# tests/test_data.py


@scenario
def range_count_take(p):
    ds = p.rd.range(100)
    assert ds.count() == 100
    rows = ds.take(5)
    assert rows == [{"id": i} for i in range(5)]
    return rows


@scenario
def map_batches_numpy(p):
    ds = p.rd.range(1000).map_batches(lambda b: {"id": b["id"] * 2})
    vals = _ids(ds.take_all())
    assert sorted(vals) == [2 * i for i in range(1000)]
    return vals


@scenario
def map_fusion_is_single_stage(p):
    ds = p.rd.range(100).map_batches(lambda b: {"id": b["id"] + 1}) \
        .map_batches(lambda b: {"id": b["id"] * 3})
    vals = _ids(ds.take_all())
    assert sorted(vals) == sorted(3 * (i + 1) for i in range(100))
    names = [s.name for s in ds._last_stats.ops]
    assert any("+" in n for n in names), names
    return vals, names


@scenario
def map_row_filter_flat_map(p):
    ds = p.rd.range(20).map(lambda r: {"v": r["id"] + 1})
    ds = ds.filter(lambda r: r["v"] % 2 == 0)
    ds = ds.flat_map(lambda r: [{"v": r["v"]}, {"v": -r["v"]}])
    vals = _ids(ds.take_all(), "v")
    evens = [i + 1 for i in range(20) if (i + 1) % 2 == 0]
    assert sorted(vals) == sorted(evens + [-e for e in evens])
    return vals


@scenario
def actor_pool_map_batches(p):
    class AddConst:
        def __init__(self, c):
            self.c = c

        def __call__(self, batch):
            return {"id": batch["id"] + self.c}

    ds = p.rd.range(200).map_batches(AddConst, fn_constructor_args=(10,),
                                     concurrency=2)
    vals = _ids(ds.take_all())
    assert sorted(vals) == [i + 10 for i in range(200)]
    return vals


@scenario
def columns_ops(p):
    ds = p.rd.range(10).add_column("sq", lambda b: b["id"] ** 2)
    ds = ds.rename_columns({"id": "n"})
    cols = ds.columns()
    assert set(cols) == {"n", "sq"}
    rows = ds.sort("n").take(3)
    assert rows[2] == {"n": 2, "sq": 4}
    ds2 = ds.drop_columns(["sq"])
    assert ds2.columns() == ["n"]
    return cols, rows, ds.select_columns(["sq"]).take(2)


@scenario
def repartition(p):
    ds = p.rd.range(100, override_num_blocks=7).repartition(3)
    mat = ds.materialize()
    assert mat.num_blocks() == 3
    assert mat.count() == 100
    vals = _ids(mat.take_all())
    assert sorted(vals) == list(range(100))
    return vals, [m.num_rows for _, m in mat._bundles]


@scenario
def random_shuffle_preserves_multiset(p):
    ds = p.rd.range(300, override_num_blocks=4).random_shuffle(seed=7)
    vals = _ids(ds.take_all())
    assert sorted(vals) == list(range(300))
    assert vals != list(range(300))  # actually shuffled
    return vals


@scenario
def sort(p):
    rng = np.random.default_rng(0)
    items = [{"k": int(v)} for v in rng.permutation(500)]
    ds = p.rd.from_items(items, override_num_blocks=5).sort("k")
    vals = _ids(ds.take_all(), "k")
    assert vals == list(range(500))
    desc = p.rd.from_items(items, override_num_blocks=5).sort(
        "k", descending=True)
    down = _ids(desc.take_all(), "k")
    assert down == list(range(499, -1, -1))
    return vals, down


@scenario
def groupby_aggregate(p):
    items = [{"g": i % 3, "v": i} for i in range(30)]
    ds = p.rd.from_items(items).groupby("g").sum("v")
    rows = {r["g"]: r["sum(v)"] for r in ds.take_all()}
    expected = {g: sum(i for i in range(30) if i % 3 == g) for g in range(3)}
    assert rows == expected
    return rows


@scenario
def global_aggregates(p):
    ds = p.rd.range(101)
    got = [ds.sum("id"), ds.min("id"), ds.max("id"), ds.mean("id")]
    assert got[:3] == [5050, 0, 100]
    assert abs(got[3] - 50.0) < 1e-9
    return got, [type(x).__name__ for x in got]


@scenario
def limit_union_zip(p):
    a = p.rd.range(10)
    b = p.rd.range(10).map_batches(lambda x: {"id": x["id"] + 10})
    u = _ids(a.union(b).take_all())
    assert sorted(u) == list(range(20))
    z = p.rd.range(5).zip(p.rd.range(5).map_batches(
        lambda x: {"other": x["id"] * 2}))
    rows = z.sort("id").take_all()
    assert rows == [{"id": i, "other": 2 * i} for i in range(5)]
    assert p.rd.range(100).limit(7).count() == 7
    return u, rows, _ids(p.rd.range(100).limit(7).take_all())


@scenario
def iter_batches_shapes(p):
    ds = p.rd.range(1000)
    sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=128)]
    assert sum(sizes) == 1000
    assert all(s == 128 for s in sizes[:-1])
    dropped = [len(b["id"]) for b in
               ds.iter_batches(batch_size=128, drop_last=True)]
    assert all(s == 128 for s in dropped)
    return sizes, dropped


@scenario
def iter_batches_local_shuffle(p):
    ds = p.rd.range(512, override_num_blocks=4)
    flat = np.concatenate(
        [b["id"] for b in ds.iter_batches(
            batch_size=64, local_shuffle_buffer_size=256,
            local_shuffle_seed=3)])
    assert sorted(flat.tolist()) == list(range(512))
    assert flat.tolist() != list(range(512))
    return flat.tolist()


@scenario
def iter_torch_batches(p):
    ds = p.rd.range(32)
    batches = list(ds.iter_torch_batches(batch_size=16, device="cpu"))
    assert isinstance(batches[0]["id"], torch.Tensor)
    return [(b["id"].dtype, b["id"].tolist()) for b in batches]


@scenario
def streaming_split(p):
    ds = p.rd.range(400, override_num_blocks=8)
    shards = ds.streaming_split(2)
    seen, per_shard = [], []
    for it in shards:
        mine = []
        for b in it.iter_batches(batch_size=None, prefetch_batches=0):
            mine.extend(b["id"].tolist())
        seen.extend(mine)
        per_shard.append(mine)
    assert sorted(seen) == list(range(400))
    return per_shard


@scenario
def map_groups(p):
    items = [{"g": i % 4, "v": float(i)} for i in range(40)]

    def normalize(batch):
        return {"g": batch["g"][:1], "total": [batch["v"].sum()]}

    ds = p.rd.from_items(items).groupby("g").map_groups(normalize)
    rows = {r["g"]: r["total"] for r in ds.take_all()}
    assert len(rows) == 4
    for g in range(4):
        assert rows[g] == sum(float(i) for i in range(40) if i % 4 == g)
    return rows


@scenario
def schema_and_stats(p):
    """Column names and ``stats()`` (the JAX package's schema is
    pyarrow's, the port's ``{column: (dtype, trailing shape)}``)."""
    ds = p.rd.range(10)
    s = ds.schema()
    names = list(s.names) if hasattr(s, "names") else list(s)
    assert names == ["id"]
    ds.count()
    stats = ds.stats()
    assert "Read" in stats
    # each op's line without its seconds
    return names, [line.rsplit(",", 1)[0] for line in stats.splitlines()]


@scenario
def groupby_string_keys_across_blocks(p):
    items = [{"g": ["apple", "banana", "cherry"][i % 3], "v": 1}
             for i in range(60)]
    ds = p.rd.from_items(items, override_num_blocks=6).groupby("g").count()
    rows = {r["g"]: r["count()"] for r in ds.take_all()}
    assert rows == {"apple": 20, "banana": 20, "cherry": 20}
    return rows


@scenario
def multidim_batch_roundtrip(p):
    arr = np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2)
    ds = p.rd.from_numpy(arr, column="img")
    out = ds.map_batches(lambda b: {"img": b["img"] * 2}).take_batch(
        4, batch_format="numpy")
    assert out["img"].shape == (4, 3, 2)
    assert out["img"].dtype == np.float32
    np.testing.assert_allclose(out["img"], arr * 2)
    return out["img"].tolist()


@scenario
def actor_compute_with_plain_fn(p):
    ds = p.rd.range(40).map_batches(lambda b: {"id": b["id"] + 5},
                                    compute="actors", concurrency=2)
    vals = _ids(ds.take_all())
    assert sorted(vals) == [i + 5 for i in range(40)]
    return vals


@scenario
def unseeded_shuffles_differ(p):
    ds = p.rd.range(200, override_num_blocks=2)
    a = _ids(ds.random_shuffle().take_all())
    b = _ids(ds.random_shuffle().take_all())
    assert sorted(a) == sorted(b) == list(range(200))
    assert a != b
    return len(a), len(b)


@scenario
def op_token_prevents_policy_aliasing(p):
    """Two concurrent executions sharing a display name reach an
    identity-keyed policy under distinct op_tokens with balanced
    launch/complete accounting."""
    class Recording(p.bp.OutputBytesPolicy):
        def __init__(self):
            super().__init__(1 << 30)
            self.lock = threading.Lock()
            self.launches = {}
            self.completes = {}
            self.names = {}

        def on_launch(self, snap):
            with self.lock:
                self.launches[snap.op_token] = \
                    self.launches.get(snap.op_token, 0) + 1
                self.names[snap.op_token] = snap.op_name

        def on_complete(self, op_token, out_bytes):
            with self.lock:
                self.completes[op_token] = \
                    self.completes.get(op_token, 0) + 1

    rec = Recording()
    ctx = p.ctx.get_current()
    old = ctx.backpressure_policies
    ctx.backpressure_policies = [rec, p.bp.ConcurrencyCapPolicy()]
    try:
        def run(out, idx):
            ds = p.rd.range(64, override_num_blocks=4).map_batches(
                lambda b: {"id": b["id"] + 1})
            out[idx] = sorted(r["id"] for r in ds.take_all())

        out = [None, None]
        threads = [threading.Thread(target=run, args=(out, i))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert out[0] == out[1] == [i + 1 for i in range(64)]
    finally:
        ctx.backpressure_policies = old

    by_name = {}
    for tok, name in rec.names.items():
        by_name.setdefault(name, set()).add(tok)
    shared = {n: toks for n, toks in by_name.items() if "MapBatches" in n}
    assert shared, rec.names
    assert all(len(toks) >= 2 for toks in shared.values()), by_name
    for tok, n in rec.launches.items():
        assert rec.completes.get(tok, 0) == n, (tok, rec.launches,
                                                rec.completes)
    return sorted((n, len(toks)) for n, toks in by_name.items())


@scenario
def output_bytes_policy_semantics(p):
    pol = p.bp.OutputBytesPolicy(max_outstanding_bytes=100)

    def snap(in_flight, bpt, outstanding):
        return p.bp.OpSnapshot(op_name="op", in_flight=in_flight, window=8,
                               bytes_per_task=bpt,
                               outstanding_bytes=outstanding, op_token="t")

    got = [pol.can_launch(snap(0, 0.0, 0)), pol.can_launch(snap(1, 0.0, 0)),
           pol.can_launch(snap(2, 0.0, 0)), pol.can_launch(snap(4, 10.0, 99)),
           pol.can_launch(snap(4, 10.0, 100))]
    assert got == [True, True, False, True, False]
    return got


@scenario
def iterator_block_prefetch_preserves_order(p):
    ds = p.rd.range(200, override_num_blocks=8)
    it = ds.iterator()
    rows = _ids(it.iter_rows())
    assert rows == list(range(200))
    again = _ids(it.iter_rows())
    assert again == list(range(200))
    return rows


@scenario
def executor_metrics_instrumented(p):
    """The streaming executor reports per-op rows/bytes/tasks into
    util.metrics (the JAX package's four families)."""
    ds = p.rd.range(128, override_num_blocks=4).map_batches(
        lambda b: {"id": b["id"] * 2})
    assert ds.count() == 128
    snaps = {s["name"]: s for s in p.metrics.snapshot()}
    fams = ["data_op_" + suffix for suffix in METRIC_SUFFIXES]
    for fam in fams:
        assert fam in snaps, sorted(snaps)
    rows = snaps[fams[0]]
    assert rows["tag_keys"] == ("op",)
    read_rows = sum(v for tags, v in rows["values"].items()
                    if tags and tags[0] == "Read")
    assert read_rows >= 128, rows["values"]
    assert sum(snaps[fams[2]]["values"].values()) > 0
    return [snaps[f]["tag_keys"] for f in fams]


# ---------------------------------------------------------------------------
# beyond tests/test_data.py: JAX's rows and Arrow's semantics


@scenario
def seeded_shuffle_gives_jaxs_rows(p):
    """The same generator calls in the same order: JAX's rows, row for
    row, multi-dim and string columns included."""
    items = [{"k": i, "s": f"r{i % 7}", "v": np.full(3, i, np.int32)}
             for i in range(50)]
    ds = p.rd.from_items(items, override_num_blocks=3).random_shuffle(
        seed=11)
    rows = [(r["k"], r["s"], np.asarray(r["v"]).tolist())
            for r in ds.take_all()]
    ids = _ids(p.rd.range(300, override_num_blocks=4).random_shuffle(
        seed=7).take_all())
    return rows, ids


@scenario
def std_is_arrows(p):
    """Arrow's stddev (ddof 0), globally and per group, and mean of ints
    as a float.  Arrow sums in another order than numpy: the two agree
    within ``STD_RTOL``."""
    items = [{"g": i % 3, "x": float(i) ** 1.5, "n": i} for i in range(31)]
    ds = p.rd.from_items(items, override_num_blocks=4)
    grouped = sorted(
        (r["g"], r["std(x)"], r["mean(n)"]) for r in
        ds.groupby("g").aggregate(("std", "x"), ("mean", "n")).take_all())
    got = [ds.std("x"), ds.std("n"), p.rd.range(101).std("id"), grouped]
    assert abs(got[2] - float(np.std(np.arange(101)))) < 1e-12
    return got


@scenario
def aggregates_skip_nulls(p):
    """count, sum, min, max and mean of a column skip its nulls (rows
    without the column)."""
    items = [{"g": i % 2, "v": i} if i % 3 else {"g": i % 2}
             for i in range(12)]
    ds = p.rd.from_items(items, override_num_blocks=3)
    rows = sorted(
        (r["g"], r["count(v)"], r["sum(v)"], r["min(v)"], r["max(v)"],
         r["mean(v)"], r["count()"]) for r in ds.groupby("g").aggregate(
            ("count", "v"), ("sum", "v"), ("min", "v"), ("max", "v"),
            ("mean", "v"), ("count", None)).take_all())
    return rows, ds.sum("v"), ds.mean("v")


@scenario
def sort_by_strings(p):
    rng = np.random.default_rng(4)
    words = [f"w{int(x):03d}" for x in rng.integers(0, 200, 60)]
    items = [{"s": w, "i": i} for i, w in enumerate(words)]
    up = [(r["s"], r["i"]) for r in p.rd.from_items(
        items, override_num_blocks=4).sort("s").take_all()]
    down = [r["s"] for r in p.rd.from_items(
        items, override_num_blocks=4).sort("s", descending=True).take_all()]
    assert [s for s, _ in up] == sorted(words)
    assert down == sorted(words, reverse=True)
    return up, down


@scenario
def right_and_outer_joins(p):
    """Arrow's columns (order included) and nulls for each join type."""
    left = p.rd.from_items([{"k": i, "a": i * 10} for i in range(6)])
    right = p.rd.from_items([{"k": i, "b": f"b{i}"} for i in range(3, 9)])
    out = {}
    for how in ("inner", "left", "right", "outer"):
        rows = left.join(right, on="k", how=how, num_partitions=3).take_all()
        out[how] = sorted((list(r.items()) for r in rows),
                          key=lambda items: dict(items)["k"])
    assert [dict(r)["k"] for r in out["outer"]] == list(range(9))
    return out


# ---------------------------------------------------------------------------
# tests/test_data_extras.py


@scenario
def join_inner_and_left(p):
    left = p.rd.from_items([{"k": i, "a": i * 10} for i in range(8)])
    right = p.rd.from_items([{"k": i, "b": i * 100} for i in range(4, 12)])
    inner = sorted(left.join(right, on="k").take_all(), key=lambda r: r["k"])
    assert [r["k"] for r in inner] == [4, 5, 6, 7]
    assert all(r["b"] == r["k"] * 100 and r["a"] == r["k"] * 10
               for r in inner)
    left_j = sorted(left.join(right, on="k", how="left").take_all(),
                    key=lambda r: r["k"])
    assert [r["k"] for r in left_j] == list(range(8))
    assert left_j[0]["b"] is None  # unmatched left rows keep nulls
    assert left_j[7]["b"] == 700
    return inner, left_j


@scenario
def join_multi_partition_consistency(p):
    n = 200
    left = p.rd.range(n).map_batches(
        lambda b: {"k": b["id"] % 17, "v": b["id"]})
    right = p.rd.from_items([{"k": i, "w": -i} for i in range(17)])
    out = left.join(right, on="k", num_partitions=5).take_all()
    assert len(out) == n
    assert all(r["w"] == -(r["v"] % 17) for r in out)
    return sorted((r["v"], r["k"], r["w"]) for r in out)


@scenario
def actor_pool_autoscaling(p):
    class Slowish:
        def __call__(self, batch):
            import time

            time.sleep(0.4)
            return batch

    ds = p.rd.range(64, override_num_blocks=16).map_batches(
        Slowish, concurrency=(1, 3), batch_size=4)
    assert ds.count() == 64
    scaled = sum(getattr(s, "actors_scaled_up", 0)
                 for s in ds._last_stats.ops)
    assert scaled >= 1, [vars(s) for s in ds._last_stats.ops]
    return scaled >= 1


@scenario
def join_with_empty_side(p):
    left = p.rd.from_items([{"k": i, "a": i} for i in range(4)])
    empty = left.filter(lambda r: r["k"] > 100)
    inner = left.join(empty, on="k").count()
    assert inner == 0
    kept = left.join(empty, on="k", how="left").take_all()
    assert sorted(r["k"] for r in kept) == [0, 1, 2, 3]
    return inner, sorted((r["k"], r["a"]) for r in kept)


@scenario
def backpressure_policies_gate_launches(p):
    ctx = p.ctx.get_current()

    class CountingCap(p.bp.BackpressurePolicy):
        def __init__(self, cap):
            self.cap = cap
            self.calls = 0
            self.max_seen = 0

        def can_launch(self, snap):
            self.calls += 1
            self.max_seen = max(self.max_seen, snap.in_flight)
            return snap.in_flight < self.cap

    pol = CountingCap(cap=2)
    old = ctx.backpressure_policies
    ctx.backpressure_policies = [pol]
    try:
        ds = p.rd.range(64, override_num_blocks=8).map(lambda r: r)
        total = sum(r["id"] for r in ds.iter_rows())
        assert total == sum(range(64))
        assert pol.calls > 0
        assert pol.max_seen <= 2
    finally:
        ctx.backpressure_policies = old

    kinds = [type(x) for x in p.bp.default_policies()]
    assert (p.bp.ConcurrencyCapPolicy in kinds
            and p.bp.OutputBytesPolicy in kinds)

    class Probe(p.bp.BackpressurePolicy):
        def __init__(self):
            self.max_seen = 0

        def can_launch(self, snap):
            self.max_seen = max(self.max_seen, snap.in_flight)
            return True

    probe = Probe()
    ctx.backpressure_policies = [
        p.bp.OutputBytesPolicy(max_outstanding_bytes=1), probe]
    try:
        ds = p.rd.range(32, override_num_blocks=8).map_batches(
            lambda b: {"x": np.zeros((len(b["id"]), 1000))})
        n = sum(1 for _ in ds.iter_rows())
        assert n == 32
        assert probe.max_seen <= 2
    finally:
        ctx.backpressure_policies = old
    return total, pol.max_seen, [k.__name__ for k in kinds], n


@scenario
def resource_manager_caps_total_across_ops(p):
    rm = p.bp.ResourceManagerPolicy(max_total_tasks=3)

    class TotalProbe(p.bp.BackpressurePolicy):
        def __init__(self, rm):
            self.rm = rm
            self.max_total = 0

        def can_launch(self, snap):
            return True

        def on_launch(self, snap):
            self.max_total = max(self.max_total, self.rm.total_in_flight())

    probe = TotalProbe(rm)
    ctx = p.ctx.get_current()
    old = ctx.backpressure_policies
    ctx.backpressure_policies = [rm, probe]
    try:
        ds = p.rd.range(48, override_num_blocks=8) \
            .map(lambda r: {"id": r["id"] * 2}) \
            .map(lambda r: {"id": r["id"] + 1})
        total = sum(r["id"] for r in ds.iter_rows())
        assert total == sum(i * 2 + 1 for i in range(48))
        assert probe.max_total <= 3, probe.max_total
        assert rm.total_in_flight() == 0
    finally:
        ctx.backpressure_policies = old
    return total, probe.max_total <= 3


# relative bound of a scenario whose floats may differ in the last bits
# (summation order), where every other scenario's results are equal
STD_RTOL = 1e-12
RTOL = {"std_is_arrows": STD_RTOL}


def _close(a, b, rtol):
    """Equal structures whose floats agree within ``rtol``."""
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= rtol * max(abs(a), abs(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_close(x, y, rtol) for x, y in zip(a, b)))
    return a == b


def _bounded(fn, *args):
    """``fn(*args)`` on a thread, failing after TIMEOUT s."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(fn, *args).result(timeout=TIMEOUT)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_jax(name, ray_cluster, port):
    results = {pkg: _bounded(SCENARIOS[name], p)
               for pkg, p in _packages().items()}
    if name in RTOL:
        assert _close(results["torch"], results["jax"], RTOL[name]), results
    else:
        assert results["torch"] == results["jax"]
    assert results["jax"] is not None


def test_unported_paths_raise_with_their_reason(port):
    from ray_tpu_torch import data

    ds = data.range(4)
    with pytest.raises(NotImplementedError, match="JAX"):
        ds.iter_jax_batches()


def _tf_feed(data, feature_columns):
    """``tests/test_tf_and_accelerators.py``'s case on ``data``'s package:
    its items, its batches and its ``to_tf`` dataset, read back as numpy."""
    import tensorflow as tf

    ds = data.from_items([
        {"x": np.array([float(i), float(2 * i)], np.float32),
         "y": float(3 * i)} for i in range(16)])
    batches = list(ds.iter_tf_batches(batch_size=8))
    assert len(batches) >= 2
    assert batches[0]["x"].shape[1] == 2
    assert batches[0]["x"].dtype == tf.float32
    tfds = ds.to_tf(feature_columns, "y", batch_size=8)
    feats, labels = next(iter(tfds))
    x = feats if feature_columns == "x" else feats["x"]
    assert x.shape[1] == 2 and labels.shape[0] == x.shape[0]
    pairs = [(tf.nest.map_structure(lambda t: t.numpy(), f), lab.numpy())
             for f, lab in tfds]
    assert sum(int(lab.shape[0]) for _, lab in pairs) == 16
    return ([{k: (t.dtype.name, t.numpy()) for k, t in b.items()}
             for b in batches], repr(tfds.element_spec), pairs)


@pytest.mark.parametrize("feature_columns", ["x", ["x", "y"]])
def test_tf_batches_and_to_tf_agree_with_jax(feature_columns, ray_cluster,
                                             port):
    """The TF feed of each package on the same items gives the same tf
    batches (dtypes and values), the same ``to_tf`` signature and the same
    (features, labels), batch for batch."""
    pytest.importorskip("tensorflow")
    import ray_tpu.data
    import ray_tpu_torch.data

    want = _tf_feed(ray_tpu.data, feature_columns)
    got = _tf_feed(ray_tpu_torch.data, feature_columns)
    assert got[1] == want[1]
    for g, w in zip(got[0], want[0], strict=True):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k][0] == w[k][0], k
            np.testing.assert_array_equal(g[k][1], w[k][1])
    for (gf, gl), (wf, wl) in zip(got[2], want[2], strict=True):
        if isinstance(wf, dict):
            assert gf.keys() == wf.keys()
            for k in wf:
                np.testing.assert_array_equal(gf[k], wf[k])
        else:
            np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gl, wl)
