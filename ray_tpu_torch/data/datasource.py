"""Datasources: read-task generation and file writes.

Counterpart of ``ray_tpu/data/datasource.py`` (Ray's
python/ray/data/read_api.py: read_parquet, read_json, read_datasource;
_internal/datasource/*): a read is a list of zero-arg callables, each
yielding numpy blocks, scheduled as ordinary tasks by the streaming
executor.  File reads split the file list across tasks.

Parquet, CSV, JSON, images, Hugging Face datasets and Arrow tables go
through pyarrow or PIL, imported inside the function that reads or writes,
as in the JAX package; where the library is absent the call raises its
``ImportError``.  Text, binary, numpy, TFRecords, WebDataset, SQL,
ClickHouse and Avro need neither.  TFRecords are encoded and decoded here
(``tf.train.Example``'s protobuf wire format, and TFRecord framing with
masked CRC32C), where the JAX package calls tensorflow.
"""

from __future__ import annotations

import glob as glob_mod
import os
import struct
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import VALUE_COL, Block


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


def expand_paths(paths, suffixes: Optional[List[str]] = None) -> List[str]:
    """The files under ``paths``: a directory's files (walked, sorted), a
    glob's matches, or the path itself; only those ending in one of
    ``suffixes`` when given."""
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                files.extend(os.path.join(root, f) for f in sorted(names))
        elif any(c in p for c in "*?["):
            files.extend(sorted(glob_mod.glob(p)))
        else:
            files.append(p)
    if suffixes:
        files = [f for f in files
                 if any(f.endswith(s) for s in suffixes)]
    if not files:
        raise FileNotFoundError(f"no files matched {paths}")
    return files


def _file_tasks(files: List[str], parallelism: int,
                read_file: Callable[[str], Iterator[Block]]
                ) -> List[Callable]:
    tasks = []
    for group in _chunk(files, parallelism):
        def read(group=group) -> Iterator[Block]:
            for f in group:
                yield from read_file(f)

        tasks.append(read)
    return tasks


def parquet_tasks(paths, parallelism: int,
                  columns: Optional[List[str]] = None) -> List[Callable]:
    files = expand_paths(paths, [".parquet"])

    def read_file(f: str) -> Iterator[Block]:
        import pyarrow.parquet as pq

        yield block_mod.from_arrow(pq.read_table(f, columns=columns))

    return _file_tasks(files, parallelism, read_file)


def csv_tasks(paths, parallelism: int) -> List[Callable]:
    files = expand_paths(paths)

    def read_file(f: str) -> Iterator[Block]:
        import pyarrow.csv as pacsv

        yield block_mod.from_arrow(pacsv.read_csv(f))

    return _file_tasks(files, parallelism, read_file)


def json_tasks(paths, parallelism: int) -> List[Callable]:
    """JSONL files (Ray's read_json reads them through pyarrow.json)."""
    files = expand_paths(paths)

    def read_file(f: str) -> Iterator[Block]:
        import pyarrow.json as pajson

        yield block_mod.from_arrow(pajson.read_json(f))

    return _file_tasks(files, parallelism, read_file)


def text_tasks(paths, parallelism: int) -> List[Callable]:
    files = expand_paths(paths)

    def read_file(f: str) -> Iterator[Block]:
        with open(f, "r") as fh:
            lines = [ln.rstrip("\n") for ln in fh]
        yield {"text": np.array(lines, dtype=str)}

    return _file_tasks(files, parallelism, read_file)


def binary_tasks(paths, parallelism: int,
                 include_paths: bool = False) -> List[Callable]:
    files = expand_paths(paths)

    def read_file(f: str) -> Iterator[Block]:
        with open(f, "rb") as fh:
            data = fh.read()
        cols: Dict[str, Any] = {"bytes": [data]}
        if include_paths:
            cols["path"] = [f]
        yield block_mod.from_batch(cols)

    return _file_tasks(files, parallelism, read_file)


def numpy_tasks(paths, parallelism: int) -> List[Callable]:
    files = expand_paths(paths, [".npy"])

    def read_file(f: str) -> Iterator[Block]:
        arr = np.load(f)
        yield block_mod.from_batch({VALUE_COL: arr})

    return _file_tasks(files, parallelism, read_file)


IMAGE_SUFFIXES = [".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp"]


def image_tasks(paths, parallelism: int, size=None, mode: str = "RGB",
                include_paths: bool = False) -> List[Callable]:
    """Ray's _internal/datasource/image_datasource.py: each image decoded
    to a fixed-shape array (the "image" column).

    Without ``size``, all images must share one resolution: the first
    file's is probed here, and every group is held to it (groups run in
    different worker processes).
    """
    files = expand_paths(paths, IMAGE_SUFFIXES)

    expected_shape = None
    if size is None and files:
        from PIL import Image

        with Image.open(files[0]) as probe:
            if mode:
                probe = probe.convert(mode)
            expected_shape = np.asarray(probe).shape

    def read_group(group: List[str]) -> Iterator[Block]:
        from PIL import Image

        for f in group:
            img = Image.open(f)
            if mode:
                img = img.convert(mode)
            if size is not None:
                img = img.resize(tuple(size))
            arr = np.asarray(img)
            if expected_shape is not None and arr.shape != expected_shape:
                raise ValueError(
                    f"read_images: mixed image shapes {expected_shape} vs "
                    f"{arr.shape} ({f}); pass size=(w, h) to resize to "
                    f"a common resolution")
            batch: Dict[str, Any] = {"image": arr[None]}
            if include_paths:
                batch["path"] = np.array([f])
            yield block_mod.from_batch(batch)

    tasks = []
    for group in _chunk(files, parallelism):
        def read(group=group) -> Iterator[Block]:
            yield from read_group(group)

        tasks.append(read)
    return tasks


def huggingface_tasks(hf_dataset, parallelism: int) -> List[Callable]:
    """Ray's read_api.py from_huggingface: one read task per slice of the
    dataset's Arrow table."""
    table = hf_dataset.data.table.combine_chunks()
    n = max(1, table.num_rows)
    per = -(-n // parallelism)
    tasks = []
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        # each task holds its slice only (a task is pickled and shipped)
        shard = table.slice(lo, hi - lo)

        def read(shard=shard) -> Iterator[Block]:
            yield block_mod.from_arrow(shard)

        tasks.append(read)
    return tasks


def items_tasks(items: List[Any], parallelism: int) -> List[Callable]:
    tasks = []
    for group in _chunk(list(items), parallelism):
        def read(group=group) -> Iterator[Block]:
            yield block_mod.from_rows(group)

        tasks.append(read)
    return tasks


# ----------------------------- writes ---------------------------------------


def make_write_fn(path: str, fmt: str, write_kwargs: Optional[dict] = None):
    """Per-block write transform: writes one file per block under ``path``
    (a random name) and yields a one-row block of the written path and its
    rows (Ray: the Write logical op planned as map tasks,
    _internal/planner/plan_write_op.py).  The rows written are the JAX
    package's ``Table.to_pylist`` rows (``block.to_pylist``)."""
    os.makedirs(path, exist_ok=True)
    write_kwargs = write_kwargs or {}

    def write_blocks(blocks: Iterator[Block]) -> Iterator[Block]:
        import uuid

        for b in blocks:
            name = f"{uuid.uuid4().hex[:12]}"
            if fmt == "parquet":
                import pyarrow.parquet as pq

                out = os.path.join(path, name + ".parquet")
                pq.write_table(block_mod.to_arrow(b), out, **write_kwargs)
            elif fmt == "csv":
                import pyarrow.csv as pacsv

                out = os.path.join(path, name + ".csv")
                pacsv.write_csv(block_mod.to_arrow(b), out)
            elif fmt == "json":
                import json as json_mod

                out = os.path.join(path, name + ".jsonl")
                with open(out, "w") as fh:
                    for row in block_mod.to_pylist(b):
                        fh.write(json_mod.dumps(row, default=str) + "\n")
            elif fmt == "tfrecords":
                out = os.path.join(path, name + ".tfrecords")
                write_tfrecord_file(block_mod.to_pylist(b), out)
            elif fmt == "avro":
                out = os.path.join(path, name + ".avro")
                write_avro_file(block_mod.to_pylist(b), out)
            else:
                raise ValueError(f"unknown write format {fmt!r}")
            yield {"path": np.array([out]),
                   "num_rows": np.array([block_mod.num_rows(b)],
                                        dtype=np.int64)}

    return write_blocks


# -- tfrecords ---------------------------------------------------------------
#
# A TFRecord file is a run of frames: u64 length | u32 masked crc32c of
# the length | payload | u32 masked crc32c of the payload.  A payload is a
# serialized tf.train.Example (tensorflow/core/example/example.proto,
# feature.proto):
#   Example  { Features features = 1; }
#   Features { map<string, Feature> feature = 1; }  (entries: key = 1,
#                                                    value = 2)
#   Feature  { oneof kind { BytesList bytes_list = 1;
#                           FloatList float_list = 2;
#                           Int64List int64_list = 3; } }
#   BytesList { repeated bytes value = 1; }
#   FloatList { repeated float value = 1 [packed = true]; }
#   Int64List { repeated int64 value = 1 [packed = true]; }

def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of TFRecord frames."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord's mask over the CRC (tensorflow/core/lib/hash/crc32c.h)."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _iter_tfrecord_frames(path: str) -> Iterator[bytes]:
    """The payloads of a TFRecord file.  The CRCs are not verified (the
    JAX package's reader, and Ray's, leave that to tf.data)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            if len(payload) < length:
                return  # truncated trailing record
            f.read(4)  # payload crc
            yield payload


def _varint(buf: bytes, pos: int):
    """The varint at ``pos`` and the position after it."""
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[tuple]:
    """(field number, wire type, value) of each field of a serialized
    message: an int for a varint, the bytes for the others."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            size, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + size], pos + size
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        if pos > n:
            raise ValueError("truncated protobuf message")
        yield num, wire, val


def _packed_varints(buf: bytes) -> np.ndarray:
    """The int64s of a packed repeated varint field."""
    b = np.frombuffer(buf, dtype=np.uint8)
    if not len(b):
        return np.zeros(0, dtype=np.int64)
    ends = np.flatnonzero(b < 0x80)
    if not len(ends) or ends[-1] != len(b) - 1:
        raise ValueError("truncated packed varints")
    starts = np.concatenate([[0], ends[:-1] + 1])
    lens = ends - starts + 1
    out = np.zeros(len(ends), dtype=np.uint64)
    for k in range(int(lens.max())):
        m = lens > k
        out[m] |= ((b[starts[m] + k] & 0x7F).astype(np.uint64)
                   << np.uint64(7 * k))
    return out.view(np.int64)


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _feature_values(buf: bytes) -> list:
    """A Feature's values as a list (empty when no kind is set)."""
    kind, values = None, []
    for num, _, val in _fields(buf):
        if num not in (1, 2, 3) or not isinstance(val, bytes):
            continue
        if num != kind:  # a oneof: the last kind set wins
            kind, values = num, []
        for inner, wire, item in _fields(val):
            if inner != 1:
                continue
            if num == 1:
                values.append(bytes(item))
            elif num == 2:
                values.extend(np.frombuffer(item, dtype="<f4")
                              .astype(np.float64).tolist())
            elif wire == 2:
                values.extend(_packed_varints(item).tolist())
            else:
                values.append(_signed64(item))
    return values


def _example_to_row(payload: bytes) -> Dict[str, Any]:
    """A tf.train.Example as a row of LISTS (unwrapping happens per column
    over the whole chunk, ``_unwrap_singletons``, so a variable-length
    feature is never a scalar in one row and a list in another)."""
    row: Dict[str, Any] = {}
    for num, _, features in _fields(payload):
        if num != 1:
            continue
        for entry_num, _, entry in _fields(features):
            if entry_num != 1:
                continue
            key, value = "", b""
            for f, _, v in _fields(entry):
                if f == 1:
                    key = bytes(v).decode()
                elif f == 2:
                    value = v
            row[key] = _feature_values(value)
    return row


def _unwrap_singletons(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per COLUMN: if every present value is a one-element list, unwrap to
    scalars (Ray's tfrecords datasource semantics)."""
    seen: Dict[str, bool] = {}
    for r in rows:
        for k, v in r.items():
            ok = isinstance(v, list) and len(v) == 1
            seen[k] = seen.get(k, True) and ok
    unwrap = {k for k, ok in seen.items() if ok}
    if not unwrap:
        return rows
    return [{k: (v[0] if k in unwrap else v) for k, v in r.items()}
            for r in rows]


def tfrecord_tasks(paths, parallelism: int,
                   raw_bytes: bool = False) -> List[Callable]:
    """Ray's _internal/datasource/tfrecords_datasource.py: rows from
    tf.train.Example records (``raw_bytes=True`` skips the decode)."""
    files = expand_paths(paths)

    def read_file(f: str) -> Iterator[Block]:
        rows: List[Dict[str, Any]] = []
        for payload in _iter_tfrecord_frames(f):
            if raw_bytes:
                rows.append({"bytes": payload})
            else:
                rows.append(_example_to_row(payload))
            if len(rows) >= 4096:
                yield block_mod.from_rows(_unwrap_singletons(rows))
                rows = []
        if rows:
            yield block_mod.from_rows(_unwrap_singletons(rows))

    return _file_tasks(files, parallelism, read_file)


def _encode_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vals: np.ndarray) -> bytes:
    """Packed varints of int64s (a negative one as ten bytes, its two's
    complement)."""
    u = np.ascontiguousarray(vals, dtype=np.int64).view(np.uint64)
    if not len(u):
        return b""
    size = np.ones(len(u), dtype=np.int64)
    for k in range(1, 10):
        size += u >= (np.uint64(1) << np.uint64(7 * k))
    out = np.empty(int(size.sum()), dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(size)[:-1]])
    for k in range(int(size.max())):
        m = size > k
        group = ((u[m] >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(
            np.uint8)
        out[starts[m] + k] = group | ((size[m] > k + 1).astype(np.uint8) << 7)
    return out.tobytes()


def _delimited(num: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return _encode_varint(num << 3 | 2) + _encode_varint(len(payload)) \
        + payload


def _row_to_example_bytes(row: Dict[str, Any]) -> bytes:
    """One row as a serialized tf.train.Example: str and bytes values a
    BytesList, ints an Int64List, anything else a FloatList, by the first
    value's type (the JAX package's rules)."""
    entries = []
    for k, v in row.items():
        vals = v if isinstance(v, (list, np.ndarray)) else [v]
        if any(x is None for x in vals):
            raise ValueError(
                f"write_tfrecords: column {k!r} contains a null; "
                f"tf.train.Example has no null representation — drop or "
                f"impute the column first (e.g. SimpleImputer)")
        first = vals[0] if len(vals) else 0
        if isinstance(first, (bytes, str)):
            body = b"".join(
                _delimited(1, x.encode() if isinstance(x, str) else bytes(x))
                for x in vals)
            feature = _delimited(1, body)
        elif isinstance(first, (int, np.integer)):
            ints = np.asarray([int(x) for x in vals], dtype=np.int64)
            feature = _delimited(3, _delimited(1, _varints(ints))
                                 if len(ints) else b"")
        else:
            floats = np.asarray([float(x) for x in vals], dtype="<f4")
            feature = _delimited(2, _delimited(1, floats.tobytes())
                                 if len(floats) else b"")
        entries.append(_delimited(1, _delimited(1, str(k).encode())
                                  + _delimited(2, feature)))
    return _delimited(1, b"".join(entries))


def _tfrecord_frame(payload: bytes) -> bytes:
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", _masked_crc(length)) + payload
            + struct.pack("<I", _masked_crc(payload)))


def write_tfrecord_file(rows: List[Dict[str, Any]], out: str) -> None:
    """Each row a framed tf.train.Example, written to ``out``."""
    with open(out, "wb") as fh:
        for row in rows:
            fh.write(_tfrecord_frame(_row_to_example_bytes(row)))


# -- webdataset --------------------------------------------------------------

def webdataset_tasks(paths, parallelism: int) -> List[Callable]:
    """Ray's _internal/datasource/webdataset_datasource.py: tar shards of
    samples; files sharing a basename form one row keyed "__key__", one
    column per extension.  .txt/.cls decode to str; other payloads stay
    bytes."""
    import tarfile

    files = expand_paths(paths, [".tar"])

    def read_file(f: str) -> Iterator[Block]:
        samples: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        with tarfile.open(f) as tar:
            for member in tar:
                if not member.isfile():
                    continue
                # the key is the full path up to the basename's first dot:
                # equal basenames in different directories are distinct
                dirname, base = os.path.split(member.name)
                stem, _, ext = base.partition(".")
                key = os.path.join(dirname, stem) if dirname else stem
                data = tar.extractfile(member).read()
                if ext in ("txt", "cls"):
                    data = data.decode("utf-8", "replace")
                if key not in samples:
                    samples[key] = {"__key__": key}
                    order.append(key)
                samples[key][ext] = data
        rows = [samples[k] for k in order]
        if rows:
            yield block_mod.from_rows(rows)

    return _file_tasks(files, parallelism, read_file)


# -- sql ---------------------------------------------------------------------

def sql_tasks(sql: str, connection_factory: Callable[[], Any],
              fetch_size: int = 4096) -> List[Callable]:
    """Ray's _internal/datasource/sql_datasource.py: any DB-API 2.0
    connection (sqlite3, psycopg2, ...).  The query runs in one read task
    (a partitioned read needs a splittable predicate, which plain SQL
    does not give); rows stream out in blocks of ``fetch_size``."""

    def read() -> Iterator[Block]:
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            names = [d[0] for d in cur.description]
            while True:
                chunk = cur.fetchmany(fetch_size)
                if not chunk:
                    break
                yield block_mod.from_rows(
                    [dict(zip(names, row)) for row in chunk])
        finally:
            conn.close()

    return [read]


def clickhouse_tasks(query: str, dsn: str, parallelism: int,
                     partition_key: Optional[str] = None,
                     user: Optional[str] = None,
                     password: Optional[str] = None) -> List[Callable]:
    """ClickHouse over the server's HTTP interface.

    Ray's _internal/datasource/clickhouse_datasource.py goes through the
    `clickhouse-connect` wheel, which speaks HTTP to port 8123; here each
    read task POSTs its partition of the query with ``FORMAT
    JSONEachRow`` and parses a line per row.  With ``partition_key`` (a
    numeric column) the query fans out over ``parallelism`` tasks by
    ``positiveModulo(key, N) = i``; without one it runs as one task.
    """
    import urllib.parse
    import urllib.request

    base = query.strip().rstrip(";")

    # positiveModulo: ClickHouse's modulo is C-style (negative for a
    # negative key, which would match no shard); a NULL key matches no
    # comparison, so shard 0 takes those rows explicitly.
    def shard_pred(i: int) -> str:
        pred = f"positiveModulo({partition_key}, {parallelism}) = {i}"
        if i == 0:
            pred = f"({pred} OR {partition_key} IS NULL)"
        return pred

    shards = ([f"SELECT * FROM ({base}) WHERE {shard_pred(i)}"
               for i in range(parallelism)]
              if partition_key and parallelism > 1 else [base])

    def make(shard_sql: str) -> Callable:
        def read() -> Iterator[Block]:
            import json as json_mod

            url = dsn.rstrip("/") + "/?" + urllib.parse.urlencode(
                {"query": shard_sql + " FORMAT JSONEachRow"})
            req = urllib.request.Request(url, method="POST")
            if user:
                req.add_header("X-ClickHouse-User", user)
            if password:
                req.add_header("X-ClickHouse-Key", password)
            with urllib.request.urlopen(req) as resp:
                rows = [json_mod.loads(line)
                        for line in resp.read().decode().splitlines()
                        if line.strip()]
            if rows:
                yield block_mod.from_rows(rows)

        return read

    return [make(s) for s in shards]


# -- avro --------------------------------------------------------------------

class _AvroDecoder:
    """Avro binary decoder (the spec's container file and core types).
    Ray's _internal/datasource/avro_datasource.py calls the `fastavro`
    wheel; this one is written out: null and deflate codecs, every core
    schema type, named-type references.  Logical types decode as their
    base type."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) < n:
            raise EOFError("truncated avro data")
        self.pos += n
        return b

    def long(self) -> int:
        shift = 0
        acc = 0
        while True:
            if self.pos >= len(self.buf):
                raise EOFError("truncated avro data")
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def decode(self, schema, names: Dict[str, Any]):
        if isinstance(schema, list):  # union
            return self.decode(schema[self.long()], names)
        if isinstance(schema, dict):
            t = schema["type"]
            if t == "record":
                return {f["name"]: self.decode(f["type"], names)
                        for f in schema["fields"]}
            if t == "enum":
                return schema["symbols"][self.long()]
            if t == "array":
                out = []
                while True:
                    n = self.long()
                    if n == 0:
                        break
                    if n < 0:
                        n = -n
                        self.long()  # the block's byte size, unused
                    out.extend(self.decode(schema["items"], names)
                               for _ in range(n))
                return out
            if t == "map":
                out = {}
                while True:
                    n = self.long()
                    if n == 0:
                        break
                    if n < 0:
                        n = -n
                        self.long()
                    for _ in range(n):
                        k = self.read(self.long()).decode()
                        out[k] = self.decode(schema["values"], names)
                return out
            if t == "fixed":
                return self.read(schema["size"])
            return self.decode(t, names)  # {"type": "string", ...} wrapper
        if schema == "null":
            return None
        if schema == "boolean":
            return self.read(1) != b"\x00"
        if schema in ("int", "long"):
            return self.long()
        if schema == "float":
            return struct.unpack("<f", self.read(4))[0]
        if schema == "double":
            return struct.unpack("<d", self.read(8))[0]
        if schema == "bytes":
            return self.read(self.long())
        if schema == "string":
            return self.read(self.long()).decode()
        if schema in names:  # named-type reference
            return self.decode(names[schema], names)
        raise ValueError(f"unsupported avro schema {schema!r}")


def _collect_named(schema, names: Dict[str, Any], namespace: str = ""):
    """Register record/enum/fixed types under both their short name and
    their fullname (the spec lets a name in a namespaced schema be
    referenced either way; nested names inherit the enclosing
    namespace)."""
    if isinstance(schema, dict):
        ns = schema.get("namespace", namespace)
        if schema.get("type") in ("record", "enum", "fixed"):
            name = schema["name"]
            names[name] = schema
            if "." in name:  # given as a fullname
                ns, _, short = name.rpartition(".")
                names[short] = schema
            elif ns:
                names[f"{ns}.{name}"] = schema
        for f in schema.get("fields", []):
            _collect_named(f["type"], names, ns)
        for k in ("items", "values"):
            if k in schema:
                _collect_named(schema[k], names, ns)
    elif isinstance(schema, list):
        for s in schema:
            _collect_named(s, names, namespace)


def avro_tasks(paths, parallelism: int) -> List[Callable]:
    """Avro Object Container Files, one row a record."""
    files = expand_paths(paths, [".avro"])

    def read_file(f: str) -> Iterator[Block]:
        for rows in _avro_file_blocks(f):
            if rows:
                yield block_mod.from_rows(rows)

    return _file_tasks(files, parallelism, read_file)


class _AvroEncoder:
    """Avro binary encoder, the write half of ``_AvroDecoder`` (null
    codec, core types), behind ``write_avro``; Ray calls `fastavro`."""

    def __init__(self):
        self.out = bytearray()

    def long(self, v: int):
        v = (v << 1) ^ (v >> 63)  # zigzag (Python's >> floors: -1 for <0)
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                break

    def encode(self, value, schema, names: Dict[str, Any]):
        if isinstance(schema, list):  # union
            # an exact branch first (an int binds to a long branch before a
            # double one, or precision drops), then the lenient pass (an
            # int widening into a double-only union)
            for lenient in (False, True):
                for i, branch in enumerate(schema):
                    if _avro_union_match(value, branch, names, lenient):
                        self.long(i)
                        return self.encode(value, branch, names)
            raise ValueError(f"no union branch for {type(value)} in {schema}")
        if isinstance(schema, dict):
            t = schema["type"]
            if t == "record":
                for f in schema["fields"]:
                    self.encode(value.get(f["name"]), f["type"], names)
                return
            if t == "enum":
                self.long(schema["symbols"].index(value))
                return
            if t == "array":
                if value:
                    self.long(len(value))
                    for item in value:
                        self.encode(item, schema["items"], names)
                self.long(0)
                return
            if t == "map":
                if value:
                    self.long(len(value))
                    for k, v in value.items():
                        kb = k.encode()
                        self.long(len(kb))
                        self.out += kb
                        self.encode(v, schema["values"], names)
                self.long(0)
                return
            if t == "fixed":
                self.out += value
                return
            return self.encode(value, t, names)
        if schema == "null":
            return
        if schema == "boolean":
            self.out.append(1 if value else 0)
            return
        if schema in ("int", "long"):
            self.long(int(value))
            return
        if schema == "float":
            self.out += struct.pack("<f", value)
            return
        if schema == "double":
            self.out += struct.pack("<d", float(value))
            return
        if schema == "bytes":
            self.long(len(value))
            self.out += value
            return
        if schema == "string":
            b = value.encode() if isinstance(value, str) else bytes(value)
            self.long(len(b))
            self.out += b
            return
        if schema in names:
            return self.encode(value, names[schema], names)
        raise ValueError(f"unsupported avro schema {schema!r}")


def _avro_union_match(value, branch, names: Dict[str, Any],
                      lenient: bool = False) -> bool:
    b = branch["type"] if isinstance(branch, dict) else branch
    if b in names and not isinstance(branch, dict):
        branch = names[b]
        b = branch["type"]
    if b == "null":
        return value is None
    if value is None:
        return False
    if b == "boolean":
        return isinstance(value, bool)
    if b in ("int", "long"):
        return isinstance(value, int) and not isinstance(value, bool)
    if b == "double":
        # lenient: an int may widen into a double branch (a nullable
        # column inferred as ["null", "double"] still holds ints), only
        # after the exact pass found no integer branch
        if lenient:
            return (isinstance(value, (int, float))
                    and not isinstance(value, bool))
        return isinstance(value, float)
    if b == "float":
        return isinstance(value, float)  # never an int: precision
    if b == "string":
        return isinstance(value, str)
    if b in ("bytes", "fixed"):
        return isinstance(value, (bytes, bytearray))
    if b == "record":
        return isinstance(value, dict)
    if b == "array":
        return isinstance(value, (list, tuple))
    if b == "map":
        return isinstance(value, dict)
    if b == "enum":
        return isinstance(value, str)
    return False


def _infer_avro_schema(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """``write_avro``'s schema: each field's type widened over ALL its
    values (long and double give double), never the first alone (typing
    from one sample would truncate 2.5 to 2 under 'long').  A field that
    is ever None becomes a nullable union; a mix that cannot be widened
    raises."""

    def of(v):
        if isinstance(v, bool):
            return "boolean"
        if isinstance(v, int):
            return "long"
        if isinstance(v, float):
            return "double"
        if isinstance(v, (bytes, bytearray)):
            return "bytes"
        if isinstance(v, (list, tuple)):
            item = _widen((of(x) for x in v), "array item") if len(v) \
                else "string"
            return {"type": "array", "items": item}
        if isinstance(v, dict):
            vals = list(v.values())
            values = _widen((of(x) for x in vals), "map value") if vals \
                else "string"
            return {"type": "map", "values": values}
        return "string"

    def _widen(types, what: str):
        out = None
        for t in types:
            if out is None or out == t:
                out = t
            elif out in ("long", "double") and t in ("long", "double"):
                out = "double"
            else:
                raise ValueError(
                    f"write_avro: mixed {what} types {out!r} vs {t!r} "
                    "cannot be widened; cast the column first")
        return out if out is not None else "string"

    fields = []
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    for k in keys:
        vals = [v for r in rows if (v := r.get(k)) is not None]
        t = _widen((of(v) for v in vals), f"values for field {k!r}") \
            if vals else "string"
        if len(vals) < len(rows):
            t = ["null", t]
        fields.append({"name": k, "type": t})
    return {"type": "record", "name": "row", "fields": fields}


def write_avro_file(rows: List[Dict[str, Any]], out: str,
                    schema: Optional[Dict[str, Any]] = None) -> None:
    """Write an Avro Object Container File (null codec)."""
    import json as json_mod

    schema = schema or _infer_avro_schema(rows)
    names: Dict[str, Any] = {}
    _collect_named(schema, names)
    enc = _AvroEncoder()
    enc.out += b"Obj\x01"
    meta = {"avro.schema": json_mod.dumps(schema).encode(),
            "avro.codec": b"null"}
    enc.long(len(meta))
    for k, v in meta.items():
        kb = k.encode()
        enc.long(len(kb))
        enc.out += kb
        enc.long(len(v))
        enc.out += v
    enc.long(0)
    sync = os.urandom(16)
    enc.out += sync
    if rows:
        block = _AvroEncoder()
        for r in rows:
            block.encode(r, schema, names)
        enc.long(len(rows))
        enc.long(len(block.out))
        enc.out += block.out
        enc.out += sync
    with open(out, "wb") as fh:
        fh.write(bytes(enc.out))


def read_avro_rows(path: str) -> List[Dict[str, Any]]:
    """All rows of one Avro container file, eagerly."""
    rows: List[Dict[str, Any]] = []
    for block in _avro_file_blocks(path):
        rows.extend(block)
    return rows


def _avro_file_blocks(f: str) -> Iterator[List[Dict[str, Any]]]:
    import json as json_mod
    import zlib

    with open(f, "rb") as fh:
        data = fh.read()
    if data[:4] != b"Obj\x01":
        raise ValueError(f"{f}: not an avro container file")
    d = _AvroDecoder(data)
    d.pos = 4
    meta: Dict[str, bytes] = {}
    while True:
        n = d.long()
        if n == 0:
            break
        if n < 0:
            n = -n
            d.long()
        for _ in range(n):
            k = d.read(d.long()).decode()
            meta[k] = d.read(d.long())
    schema = json_mod.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    names: Dict[str, Any] = {}
    _collect_named(schema, names)
    sync = d.read(16)
    while d.pos < len(d.buf):
        count = d.long()
        size = d.long()
        payload = d.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec!r}")
        bd = _AvroDecoder(payload)
        rows = [bd.decode(schema, names) for _ in range(count)]
        if rows and not isinstance(rows[0], dict):
            rows = [{"value": r} for r in rows]  # a non-record schema
        yield rows
        if d.read(16) != sync:
            raise ValueError(f"{f}: sync marker mismatch")


# -- torch -------------------------------------------------------------------

def torch_tasks(torch_dataset, parallelism: int) -> List[Callable]:
    """Ray's read_api.py from_torch: a map-style dataset is sharded by
    index across tasks; an iterable one is read in one task."""
    if hasattr(torch_dataset, "__len__") and hasattr(torch_dataset,
                                                     "__getitem__"):
        indices = list(range(len(torch_dataset)))

        def make(idx_group):
            def read() -> Iterator[Block]:
                rows = [{"item": torch_dataset[i]} for i in idx_group]
                if rows:
                    yield block_mod.from_rows(rows)
            return read

        return [make(g) for g in _chunk(indices, parallelism)]

    def read_iterable() -> Iterator[Block]:
        rows = []
        for item in torch_dataset:
            rows.append({"item": item})
            if len(rows) >= 4096:
                yield block_mod.from_rows(rows)
                rows = []
        if rows:
            yield block_mod.from_rows(rows)

    return [read_iterable]
