"""The port's file readers, writes and constructors held to the JAX
package's on the CPU.

Every case of ``tests/test_data.py`` and ``tests/test_data_extras.py``
that reads or writes files, or builds a dataset from pandas, Arrow, Hugging
Face, torch or tf.data, is written once as a function of the package under
test.  It runs under the JAX package's session cluster (``ray_cluster``)
and under the port's runtime, started by a module fixture in the same
process, on the same files made from a numpy seed, makes its JAX test's
assertions in both, and returns the rows it read as plain Python values;
the two results must be equal.  A written file's name is random, so rows
read back from a directory are sorted by a key column.

Beyond the JAX tests: each package's writes read back through both
packages' readers to the same rows (TFRecords, Avro, JSON, CSV, Parquet);
the port's ``tf.train.Example`` codec and TFRecord framing against
tensorflow's in both directions; blocks to and from Arrow against the JAX
package's layout; and the formats the card's host reads and writes run
end to end in a subprocess whose processes cannot import pyarrow,
tensorflow or PIL.
"""

import concurrent.futures
import http.server
import io
import json
import os
import subprocess
import sys
import tarfile
import threading
import types
import urllib.parse
import zlib

import cloudpickle
import numpy as np
import pytest
import torch

# functions and classes defined here run in worker processes that cannot
# import this module: pickle them by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 120
SEED = 41
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    import ray_tpu_torch
    import ray_tpu_torch.data

    return {"jax": types.SimpleNamespace(name="jax", rt=ray_tpu,
                                         rd=ray_tpu.data),
            "torch": types.SimpleNamespace(name="torch", rt=ray_tpu_torch,
                                           rd=ray_tpu_torch.data)}


def _plain(v):
    """Plain Python values: arrays and numpy scalars to lists and
    Python numbers, recursively, a NaN as the string "nan" (so that equal
    rows compare equal)."""
    if isinstance(v, float) and v != v:
        return "nan"
    if isinstance(v, np.ndarray):
        if v.dtype.kind == "f":
            return _plain(v.tolist())
        return [_plain(x) for x in v.tolist()] if v.dtype == object \
            else v.tolist()
    if isinstance(v, np.generic):
        return _plain(v.item())
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def _rows(rows, key=None):
    out = [_plain(r) for r in rows]
    return sorted(out, key=key) if key else out


def _tfrecords_read(p, paths, raw_bytes=False):
    """The rows of ``read_tfrecords(paths)``.  The JAX package's read
    tasks run in this process: each decodes with tensorflow, and importing
    it costs ~10 s in every JAX worker process a task lands on."""
    if p.name == "torch":
        return p.rd.read_tfrecords(paths, raw_bytes=raw_bytes).take_all()
    from ray_tpu.data import block as jblock
    from ray_tpu.data import datasource as jds

    return [r for task in jds.tfrecord_tasks(paths, 4, raw_bytes=raw_bytes)
            for b in task() for r in jblock.rows_of(b)]


def _tfrecords_write(p, ds, path):
    """``ds.write_tfrecords(path)``; the JAX package's write runs on the
    dataset's blocks in this process (``_tfrecords_read``)."""
    if p.name == "torch":
        return ds.write_tfrecords(path)
    from ray_tpu.data import datasource as jds

    write = jds.make_write_fn(path, "tfrecords")
    for ref, _ in ds.iter_bundles():
        list(write(iter([p.rt.get(ref)])))


def _bounded(fn, *args):
    """``fn(*args)`` on a thread, failing after TIMEOUT s."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(fn, *args).result(timeout=TIMEOUT)


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# tests/test_data.py


@scenario
def parquet_roundtrip(p, tmp):
    path = os.path.join(tmp, "pq")
    p.rd.range(100).map_batches(
        lambda b: {"id": b["id"], "x": b["id"] * 0.5}).write_parquet(path)
    back = p.rd.read_parquet(path)
    assert back.count() == 100
    total = back.sum("x")
    assert abs(total - sum(i * 0.5 for i in range(100))) < 1e-6
    return total, _rows(back.take_all(), key=lambda r: r["id"])


@scenario
def csv_json_roundtrip(p, tmp):
    p1, p2 = os.path.join(tmp, "csv"), os.path.join(tmp, "jsonl")
    p.rd.range(50).write_csv(p1)
    assert p.rd.read_csv(p1).count() == 50
    p.rd.range(50).write_json(p2)
    assert p.rd.read_json(p2).count() == 50
    return (_rows(p.rd.read_csv(p1).take_all(), key=lambda r: r["id"]),
            _rows(p.rd.read_json(p2).take_all(), key=lambda r: r["id"]))


@scenario
def from_pandas_numpy_arrow(p, tmp):
    import pandas as pd
    import pyarrow as pa

    df = pd.DataFrame({"a": [1, 2, 3]})
    assert p.rd.from_pandas(df).count() == 3
    assert p.rd.from_numpy(np.arange(5), column="n").sum("n") == 10
    assert p.rd.from_arrow(pa.table({"b": [1.0, 2.0]})).count() == 2
    rng = np.random.default_rng(SEED)
    table = pa.table({"i": rng.integers(0, 99, 6),
                      "s": [f"s{k}" for k in range(6)],
                      "v": pa.array([[1, 2], [], [3], None, [4], [5, 6]]),
                      "f": rng.standard_normal(6)})
    ds = p.rd.from_arrow(table)
    back = ds.to_arrow()
    return (_rows(p.rd.from_pandas(table.to_pandas()).take_all()),
            _rows(ds.take_all()), back.to_pylist(),
            _plain(ds.to_pandas().to_dict("list")))


# ---------------------------------------------------------------------------
# tests/test_data_extras.py


@scenario
def read_images(p, tmp):
    from PIL import Image

    rng = np.random.default_rng(SEED)
    d = os.path.join(tmp, "img")
    os.makedirs(d)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)) \
            .save(os.path.join(d, f"img{i}.png"))
    ds = p.rd.read_images(d, size=(4, 4), include_paths=True)
    rows = ds.take_all()
    assert len(rows) == 4
    img = np.asarray(rows[0]["image"])
    assert img.shape == (4, 4, 3)
    assert any("img0.png" in r["path"] for r in rows)
    batch = next(iter(ds.iter_batches(batch_size=4, batch_format="numpy")))
    assert np.asarray(batch["image"]).shape == (4, 4, 4, 3)
    same = p.rd.read_images(d).take_all()  # one resolution: no size needed
    return (_rows([dict(r, path=os.path.basename(r["path"]))
                   for r in rows], key=lambda r: r["path"]),
            sorted(_plain(np.asarray(r["image"])) for r in same))


@scenario
def from_huggingface(p, tmp):
    import datasets

    hf = datasets.Dataset.from_dict({
        "text": [f"doc {i}" for i in range(20)],
        "label": list(range(20)),
    })
    ds = p.rd.from_huggingface(hf)
    assert ds.count() == 20
    rows = ds.filter(lambda r: r["label"] < 3).take_all()
    assert {r["text"] for r in rows} == {"doc 0", "doc 1", "doc 2"}
    return _rows(ds.take_all())


def _tf_example_file(path, rng, n=10):
    """``n`` tf.train.Example records written by tensorflow: an int64
    index, a name, a two-float vector, a variable-length id list and a
    feature only even rows hold."""
    import tensorflow as tf

    with tf.io.TFRecordWriter(path) as w:
        for i in range(n):
            feats = {
                "idx": tf.train.Feature(
                    int64_list=tf.train.Int64List(value=[i])),
                "name": tf.train.Feature(
                    bytes_list=tf.train.BytesList(
                        value=[f"row{i}".encode()])),
                "vec": tf.train.Feature(
                    float_list=tf.train.FloatList(
                        value=[float(rng.standard_normal()), 2.0])),
                "ids": tf.train.Feature(int64_list=tf.train.Int64List(
                    value=rng.integers(-2**40, 2**40, i % 3).tolist())),
            }
            if i % 2 == 0:
                feats["even"] = tf.train.Feature(
                    float_list=tf.train.FloatList(value=[i / 3]))
            ex = tf.train.Example(features=tf.train.Features(feature=feats))
            w.write(ex.SerializeToString())


@scenario
def read_tfrecords(p, tmp):
    path = os.path.join(tmp, "data.tfrecord")
    _tf_example_file(path, np.random.default_rng(SEED))
    rows = sorted(_tfrecords_read(p, path), key=lambda r: r["idx"])
    assert len(rows) == 10
    assert rows[3]["idx"] == 3
    assert bytes(rows[3]["name"]) == b"row3"
    assert list(rows[3]["vec"])[1] == 2.0
    raw = _tfrecords_read(p, path, raw_bytes=True)
    return _rows(rows), sorted(r["bytes"] for r in raw)


@scenario
def read_webdataset(p, tmp):
    rng = np.random.default_rng(SEED)
    shard = os.path.join(tmp, "shard-000.tar")
    with tarfile.open(shard, "w") as tar:
        for i in range(5):
            for ext, payload in (("txt", f"caption {i}".encode()),
                                 ("bin", bytes([i] * 4)),
                                 ("npy", rng.bytes(6) + b"\x00")):
                info = tarfile.TarInfo(f"sample{i:04d}.{ext}")
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))
    rows = sorted(p.rd.read_webdataset(shard).take_all(),
                  key=lambda r: r["__key__"])
    assert len(rows) == 5
    assert rows[2]["__key__"] == "sample0002"
    assert rows[2]["txt"] == "caption 2"
    assert bytes(rows[2]["bin"]) == bytes([2] * 4)
    return _rows(rows)


@scenario
def read_sql(p, tmp):
    import sqlite3

    db = os.path.join(tmp, "t.db")
    rng = np.random.default_rng(SEED)
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE items (id INTEGER, name TEXT, w REAL)")
    conn.executemany("INSERT INTO items VALUES (?, ?, ?)",
                     [(i, f"item{i}", float(rng.standard_normal()))
                      for i in range(20)])
    conn.commit()
    conn.close()

    ds = p.rd.read_sql("SELECT id, name, w FROM items WHERE id < 15",
                       lambda: sqlite3.connect(db), fetch_size=4)
    rows = sorted(ds.take_all(), key=lambda r: r["id"])
    assert len(rows) == 15
    assert {k: rows[7][k] for k in ("id", "name")} == {"id": 7,
                                                       "name": "item7"}
    return _rows(rows)


def _zigzag(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _avro_str(s: str) -> bytes:
    b = s.encode()
    return _zigzag(len(b)) + b


def _write_avro(path, codec: str, rng):
    """A hand-encoded Avro container file: record {idx long, name string,
    tags array<string>, w double}, an encoder independent of both
    packages' (null and deflate codecs)."""
    schema = {"type": "record", "name": "Row", "fields": [
        {"name": "idx", "type": "long"},
        {"name": "name", "type": "string"},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "w", "type": "double"},
    ]}
    rows = b""
    n_rows = 7
    for i in range(n_rows):
        rows += _zigzag(i) + _avro_str(f"r{i}")
        rows += _zigzag(2) + _avro_str("a") + _avro_str(f"t{i}") + _zigzag(0)
        rows += np.float64(rng.standard_normal()).tobytes()
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        rows = comp.compress(rows) + comp.flush()
    meta_schema = json.dumps(schema).encode()
    sync = bytes(range(16))
    buf = b"Obj\x01"
    buf += _zigzag(2)
    buf += _avro_str("avro.schema") + _zigzag(len(meta_schema)) + meta_schema
    buf += _avro_str("avro.codec") + _zigzag(len(codec)) + codec.encode()
    buf += _zigzag(0)
    buf += sync
    buf += _zigzag(n_rows) + _zigzag(len(rows)) + rows + sync
    with open(path, "wb") as f:
        f.write(buf)
    return n_rows


def _avro_scenario(codec):
    def read_avro(p, tmp):
        path = os.path.join(tmp, f"data_{codec}.avro")
        n = _write_avro(path, codec, np.random.default_rng(SEED))
        rows = sorted(p.rd.read_avro(path).take_all(),
                      key=lambda r: r["idx"])
        assert len(rows) == n
        assert {k: rows[3][k] for k in ("idx", "name", "tags")} == {
            "idx": 3, "name": "r3", "tags": ["a", "t3"]}
        return _rows(rows)

    read_avro.__name__ = f"read_avro_{codec}"
    return read_avro


for _codec in ("null", "deflate"):
    scenario(_avro_scenario(_codec))


@scenario
def from_torch_map_style(p, tmp):
    import torch.utils.data as tdata

    class Squares(tdata.Dataset):
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return i * i

    class Stream(tdata.IterableDataset):
        def __iter__(self):
            return iter(range(7))

    rows = sorted(r["item"] for r in
                  p.rd.from_torch(Squares(), override_num_blocks=3)
                  .take_all())
    assert rows == [i * i for i in range(10)]
    return rows, _rows(p.rd.from_torch(Stream()).take_all())


@scenario
def from_tf(p, tmp):
    import tensorflow as tf

    ds = tf.data.Dataset.from_tensor_slices({"x": [1, 2, 3],
                                             "y": [4.0, 5.0, 6.0]})
    rows = sorted(p.rd.from_tf(ds).take_all(), key=lambda r: r["x"])
    assert [int(r["x"]) for r in rows] == [1, 2, 3]
    assert [float(r["y"]) for r in rows] == [4.0, 5.0, 6.0]
    pairs = tf.data.Dataset.from_tensor_slices(([1, 2], [3.5, 4.5]))
    return _rows(rows), _rows(p.rd.from_tf(pairs).take_all())


@scenario
def write_tfrecords_roundtrip(p, tmp):
    """The writer's framing and CRCs read by tf.data itself (which checks
    them) and by the package's own reader."""
    import tensorflow as tf

    out = os.path.join(tmp, "tfr_out")
    _tfrecords_write(p, p.rd.from_items(
        [{"idx": i, "name": f"n{i}"} for i in range(6)]), out)
    files = [os.path.join(out, f) for f in os.listdir(out)
             if f.endswith(".tfrecords")]
    assert files
    n_tf = sum(1 for _ in tf.data.TFRecordDataset(files))
    assert n_tf == 6
    rows = sorted(_tfrecords_read(p, files), key=lambda r: r["idx"])
    assert rows[2]["idx"] == 2 and bytes(rows[2]["name"]) == b"n2"
    return _rows(rows)


@scenario
def read_avro_namespaced_reference(p, tmp):
    """A schema naming a type by its fullname (Java style) decodes."""
    schema = {"type": "record", "name": "Pair", "namespace": "com.ex",
              "fields": [
                  {"name": "a", "type": {"type": "record", "name": "P",
                                         "fields": [{"name": "v",
                                                     "type": "long"}]}},
                  {"name": "b", "type": "com.ex.P"},
              ]}
    body = _zigzag(1) + _zigzag(2)  # one row: a.v=1, b.v=2
    meta_schema = json.dumps(schema).encode()
    sync = bytes(range(16))
    buf = (b"Obj\x01" + _zigzag(2)
           + _avro_str("avro.schema")
           + _zigzag(len(meta_schema)) + meta_schema
           + _avro_str("avro.codec") + _zigzag(4) + b"null"
           + _zigzag(0) + sync
           + _zigzag(1) + _zigzag(len(body)) + body + sync)
    path = os.path.join(tmp, "ns.avro")
    with open(path, "wb") as f:
        f.write(buf)
    rows = p.rd.read_avro(path).take_all()
    assert rows == [{"a": {"v": 1}, "b": {"v": 2}}]
    return _rows(rows)


class _ClickHouseStub(http.server.BaseHTTPRequestHandler):
    """Answers FORMAT JSONEachRow over rows id 0..5 and a NULL-id row,
    emulating positiveModulo(id, N) = i, and records the queries."""

    queries = None  # set per server

    def do_POST(self):
        q = urllib.parse.parse_qs(
            urllib.parse.urlparse(self.path).query)["query"][0]
        self.server.queries.append(q)
        rows = [{"id": i, "v": i * 10} for i in range(6)]
        rows.append({"id": None, "v": -1})
        if "Modulo(id" in q:
            shard = int(q.split("= ")[-1].split()[0])
            n = int(q.split("Modulo(id, ")[1].split(")")[0])
            rows = [r for r in rows
                    if (r["id"] is not None and r["id"] % n == shard)
                    or (r["id"] is None and "id IS NULL" in q)]
        body = "\n".join(json.dumps(r) for r in rows).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@scenario
def read_clickhouse_http(p, tmp):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _ClickHouseStub)
    srv.queries = []
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        dsn = f"http://127.0.0.1:{srv.server_address[1]}"
        rows = sorted(
            p.rd.read_clickhouse(
                "SELECT id, v FROM t", dsn=dsn, partition_key="id",
                override_num_blocks=3).take_all(),
            key=lambda r: (r["id"] is None, r["id"]))
        # all six keyed rows and the NULL-key row arrive exactly once
        assert [r["v"] for r in rows] == [0, 10, 20, 30, 40, 50, -1]
        assert sum("positiveModulo(id, 3)" in q for q in srv.queries) == 3
        return _rows(rows), sorted(srv.queries)
    finally:
        srv.shutdown()
        srv.server_close()


@scenario
def write_read_avro_roundtrip(p, tmp):
    out = os.path.join(tmp, "avro_out")
    p.rd.from_items(
        [{"i": i, "name": f"n{i}", "w": i / 2, "opt": None if i % 2 else i,
          "mixed": i + 0.5 if i == 3 else i}  # long+double widens to double
         for i in range(5)]).write_avro(out)
    files = [os.path.join(out, f) for f in os.listdir(out)
             if f.endswith(".avro")]
    assert files
    rows = sorted(p.rd.read_avro(files).take_all(), key=lambda r: r["i"])
    assert [r["i"] for r in rows] == list(range(5))
    assert rows[3]["name"] == "n3" and rows[3]["opt"] is None
    assert rows[4]["opt"] == 4 and rows[2]["w"] == 1.0
    assert rows[3]["mixed"] == 3.5 and rows[2]["mixed"] == 2.0
    return _rows(rows)


@scenario
def read_text_binary_numpy(p, tmp):
    """The remaining file readers (no JAX test of their own)."""
    rng = np.random.default_rng(SEED)
    d = os.path.join(tmp, "misc")
    os.makedirs(d)
    with open(os.path.join(d, "a.txt"), "w") as f:
        f.write("first line\nsecond\n\nlast")
    with open(os.path.join(d, "b.bin"), "wb") as f:
        f.write(rng.bytes(9) + b"\x00\x00")
    np.save(os.path.join(d, "c.npy"), rng.standard_normal((4, 3)))
    text = p.rd.read_text(os.path.join(d, "a.txt")).take_all()
    binary = p.rd.read_binary_files(os.path.join(d, "b.bin"),
                                    include_paths=True).take_all()
    arr = p.rd.read_numpy(d).take_all()
    return (_rows(text), _rows([dict(r, path=os.path.basename(r["path"]))
                                for r in binary]), _rows(arr))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reader_agrees_with_jax(name, ray_cluster, port, tmp_path):
    results = {}
    for pkg, p in _packages().items():
        tmp = tmp_path / pkg
        tmp.mkdir()
        results[pkg] = _bounded(SCENARIOS[name], p, str(tmp))
    assert results["torch"] == results["jax"]
    assert results["jax"] is not None


# ---------------------------------------------------------------------------
# Each package's writes through both packages' readers.

CROSS_COLUMNS = {  # the columns each format carries
    "tfrecords": ("id", "x", "name", "b", "tok", "ids"),
    "avro": ("id", "x", "name", "b", "tok", "ids", "opt"),
    "json": ("id", "x", "name", "tok", "ids", "opt"),
    "csv": ("id", "x", "name", "opt"),
    "parquet": ("id", "x", "name", "b", "tok", "ids", "opt"),
}


def _cross_rows(n=24):
    rng = np.random.default_rng(SEED)
    return [{"id": i, "x": float(np.float32(rng.standard_normal())),
             "name": f"r{i}", "b": rng.bytes(3) + b"\x00",
             "ids": rng.integers(-50, 50, 1 + i % 3).tolist(),
             "opt": None if i % 3 == 0 else i * 7} for i in range(n)]


def _add_tokens(batch):
    """A 2-D int64 column: each row's 5 tokens from its id."""
    ids = np.asarray(batch["id"], dtype=np.int64)
    out = dict(batch)
    out["tok"] = np.stack([ids * k - 3 for k in range(5)], axis=1)
    return out


def _write(p, fmt, path):
    cols = CROSS_COLUMNS[fmt]
    rows = [{k: r[k] for k in cols if k != "tok"} for r in _cross_rows()]
    ds = p.rd.from_items(rows, override_num_blocks=3)
    if "tok" in cols:
        ds = ds.map_batches(_add_tokens)
    if fmt == "tfrecords":
        _tfrecords_write(p, ds, path)
    else:
        getattr(ds, "write_" + fmt)(path)


def _read(p, fmt, path):
    rows = (_tfrecords_read(p, path) if fmt == "tfrecords"
            else getattr(p.rd, "read_" + fmt)(path).take_all())
    return _rows(rows, key=lambda r: r["id"])


@pytest.mark.parametrize("fmt", sorted(CROSS_COLUMNS))
def test_written_files_read_alike_through_both_packages(fmt, ray_cluster,
                                                        port, tmp_path):
    pkgs = _packages()
    reads = {}
    for writer, p in pkgs.items():
        path = str(tmp_path / writer)
        _bounded(_write, p, fmt, path)
        assert len(os.listdir(path)) == 3  # a file a block
        for reader, q in pkgs.items():
            reads[writer, reader] = _bounded(_read, q, fmt, path)
    for writer in pkgs:
        assert reads[writer, "torch"] == reads[writer, "jax"], writer
    assert len(reads["jax", "jax"]) == 24
    # the writers agree but for a null in a numeric column, which a JAX
    # batch holds as NaN (map_batches) and the port's as None
    assert _nulls_as_none(reads["torch", "torch"]) \
        == _nulls_as_none(reads["jax", "jax"])


def _nulls_as_none(rows):
    return [{k: None if v == "nan" else v for k, v in r.items()}
            for r in rows]


# ---------------------------------------------------------------------------
# The TFRecord codec against tensorflow's, and blocks against Arrow.


def _codec_rows(n=12):
    rng = np.random.default_rng(SEED)
    rows = []
    for i in range(n):
        rows.append({
            "i": int(rng.integers(-2**63, 2**63 - 1)),
            "small": i,
            "f": float(rng.standard_normal()),
            "s": f"text {i} ✓",
            "raw": rng.bytes(i % 5) + b"\x00",
            "ints": rng.integers(-2**62, 2**62, 1 + i % 6).tolist(),
            "floats": rng.standard_normal(i % 4 + 1).tolist(),
            "names": [f"n{k}".encode() for k in range(i % 3 + 1)],
            "empty": [],
        })
    return rows


def test_example_codec_matches_tensorflow_both_ways():
    import tensorflow as tf

    from ray_tpu.data import datasource as jds
    from ray_tpu_torch.data import datasource as tds

    for row in _codec_rows():
        mine = tds._row_to_example_bytes(row)
        theirs = jds._row_to_example_bytes(row)  # tensorflow's encoder
        assert tf.train.Example.FromString(mine) \
            == tf.train.Example.FromString(theirs)
        for payload in (mine, theirs):  # tensorflow's decoder
            assert tds._example_to_row(payload) \
                == jds._example_to_row(payload)
    with pytest.raises(ValueError, match="null"):
        tds._row_to_example_bytes({"a": [1, None]})
    assert tds.crc32c(b"123456789") == 0xE3069283  # the check value


def test_tfrecord_framing_matches_tensorflow_both_ways(tmp_path):
    import tensorflow as tf

    from ray_tpu.data import datasource as jds
    from ray_tpu_torch.data import datasource as tds

    rows = _codec_rows()
    mine, theirs = str(tmp_path / "mine.tfrecords"), \
        str(tmp_path / "theirs.tfrecords")
    tds.write_tfrecord_file(rows, mine)
    jds.write_tfrecord_file(rows, theirs)  # tf.io.TFRecordWriter
    # tf.data verifies both masked CRCs of every frame
    read_by_tf = [bytes(x.numpy()) for x in tf.data.TFRecordDataset([mine])]
    assert [tf.train.Example.FromString(x) for x in read_by_tf] == [
        tf.train.Example.FromString(bytes(x.numpy()))
        for x in tf.data.TFRecordDataset([theirs])]
    assert list(tds._iter_tfrecord_frames(theirs)) == [
        bytes(x.numpy()) for x in tf.data.TFRecordDataset([theirs])]
    assert list(tds._iter_tfrecord_frames(mine)) == read_by_tf
    with open(mine, "rb") as f:  # a flipped payload byte fails tf.data
        buf = bytearray(f.read())
    buf[20] ^= 0xFF
    (tmp_path / "bad.tfrecords").write_bytes(bytes(buf))
    with pytest.raises(tf.errors.DataLossError):
        list(tf.data.TFRecordDataset([str(tmp_path / "bad.tfrecords")]))


def _arrow_columns(n=7):
    rng = np.random.default_rng(SEED)
    return {
        "img": rng.standard_normal((n, 2, 3)).astype(np.float32),
        "tok": rng.integers(0, 50000, (n, 5)),
        "i": rng.integers(-9, 9, n),
        "f": rng.standard_normal(n),
        "flag": rng.standard_normal(n) > 0,
        "s": np.array([f"s{k}" for k in range(n)]),
    }


def test_blocks_convert_to_and_from_arrow_as_jax_lays_them_out():
    import pyarrow as pa

    from ray_tpu.data import block as jblock
    from ray_tpu_torch.data import block as tblock

    cols = _arrow_columns()
    theirs = jblock.from_batch(dict(cols))
    mine = tblock.to_arrow(tblock.from_batch(dict(cols)))
    assert mine.equals(theirs, check_metadata=True)
    back = tblock.from_arrow(theirs)
    for k, v in cols.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
    # a list column, bytes and nulls: the port's object columns
    table = pa.table({"v": pa.array([[1, 2], None, []]),
                      "b": pa.array([b"a\x00", None, b""]),
                      "n": pa.array([1, None, 3])})
    block = tblock.from_arrow(table)
    assert [_plain(r) for r in tblock.rows_of(block)] == table.to_pylist()
    assert tblock.to_pylist(block) == table.to_pylist()
    assert tblock.to_arrow(block).equals(table)


# ---------------------------------------------------------------------------
# The card's host has neither pyarrow, tensorflow nor PIL.

BLOCKED = ("pyarrow", "tensorflow", "PIL")

CARD_FORMATS = """
import io, os, sqlite3, sys, tarfile
import numpy as np
for name in {blocked!r}:
    assert sys.modules.get(name, 0) is None, name
import ray_tpu_torch as rt
from ray_tpu_torch import data
from torch.utils.data import Dataset as TorchDataset

tmp = sys.argv[1]
rt.init(num_cpus=2, min_workers=1, object_store_memory=1 << 27)
try:
    rng = np.random.default_rng(3)
    ds = data.range(30, override_num_blocks=3).map_batches(
        lambda b: {{"id": b["id"], "tok": np.stack([b["id"]] * 4, axis=1),
                   "x": b["id"] / 4, "b": [bytes([int(i)]) for i in b["id"]],
                   "s": np.array([f"r{{i}}" for i in b["id"]])}})
    want = sorted(ds.take_all(), key=lambda r: r["id"])
    for fmt in ("tfrecords", "avro"):
        getattr(ds, "write_" + fmt)(os.path.join(tmp, fmt))
        got = sorted(getattr(data, "read_" + fmt)(os.path.join(tmp, fmt))
                     .take_all(), key=lambda r: r["id"])
        assert [r["id"] for r in got] == list(range(30)), fmt
        for g, w in zip(got, want):
            assert list(g["tok"]) == list(w["tok"]) and g["x"] == w["x"]
            assert bytes(g["b"]) == w["b"]
    ds.write_json(os.path.join(tmp, "json"))
    with open(os.path.join(tmp, "a.txt"), "w") as f:
        f.write("x\\ny\\n")
    assert data.read_text(os.path.join(tmp, "a.txt")).count() == 2
    assert data.read_binary_files(os.path.join(tmp, "a.txt")).take_all() \\
        == [{{"bytes": b"x\\ny\\n"}}]
    np.save(os.path.join(tmp, "n.npy"), rng.standard_normal((5, 2)))
    assert data.read_numpy(os.path.join(tmp, "n.npy")).count() == 5
    with tarfile.open(os.path.join(tmp, "s.tar"), "w") as tar:
        info = tarfile.TarInfo("k0.txt")
        info.size = 2
        tar.addfile(info, io.BytesIO(b"hi"))
    assert data.read_webdataset(os.path.join(tmp, "s.tar")).take_all() \\
        == [{{"__key__": "k0", "txt": "hi"}}]
    db = os.path.join(tmp, "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (i INTEGER)")
    conn.executemany("INSERT INTO t VALUES (?)", [(i,) for i in range(4)])
    conn.commit()
    conn.close()
    assert data.read_sql("SELECT i FROM t", lambda: sqlite3.connect(db)) \\
        .count() == 4

    class Sq(TorchDataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return i * i

    assert sorted(r["item"] for r in data.from_torch(Sq()).take_all()) \\
        == [0, 1, 4, 9]

    class Duck:
        def as_numpy_iterator(self):
            return iter([{{"a": 1}}, {{"a": 2}}])

    assert data.from_tf(Duck()).count() == 2
    for call, name in (
            (lambda: data.read_parquet(os.path.join(tmp, "x.parquet"))
             .count(), "pyarrow"),
            (lambda: data.read_csv(os.path.join(tmp, "a.txt")).count(),
             "pyarrow"),
            (lambda: data.read_json(os.path.join(tmp, "json")).count(),
             "pyarrow"),
            (lambda: data.read_images(os.path.join(tmp, "a.png")), "PIL"),
            (lambda: data.from_arrow(None), "pyarrow"),
            (ds.to_arrow, "pyarrow"), (ds.to_pandas, "pyarrow"),
            (lambda: ds.write_parquet(os.path.join(tmp, "pq")), "pyarrow")):
        with open(os.path.join(tmp, "x.parquet"), "w"), \\
                open(os.path.join(tmp, "a.png"), "w"):
            pass
        try:
            call()
        except ImportError as e:
            assert name in str(e), (name, e)
        else:
            raise AssertionError(f"no ImportError naming {{name}}")
    for name in {blocked!r}:
        assert sys.modules.get(name, 0) is None, name
    print("CARD-FORMATS-OK")
finally:
    rt.shutdown()
"""


def test_card_formats_run_without_pyarrow_tensorflow_or_pil(tmp_path):
    """Every process of the run (the driver and the runtime's workers,
    through a ``sitecustomize`` on their path) has pyarrow, tensorflow and
    PIL set to None in ``sys.modules``, so importing one raises."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import sys\n" + "".join(f"sys.modules[{n!r}] = None\n"
                                 for n in BLOCKED))
    work = tmp_path / "work"
    work.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(site), REPO]))
    proc = subprocess.run(
        [sys.executable, "-c", CARD_FORMATS.format(blocked=BLOCKED),
         str(work)], capture_output=True, text=True, timeout=TIMEOUT,
        env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "CARD-FORMATS-OK" in proc.stdout
