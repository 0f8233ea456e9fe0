"""MongoDB datasource over the raw wire protocol: no pymongo, no pyarrow.

Counterpart of ``ray_tpu/data/mongo.py`` (Ray's mongo datasource,
python/ray/data/_internal/datasource/mongo_datasource.py, wraps pymongo
and pymongoarrow).  This module speaks the wire protocol directly: OP_MSG
(opcode 2013, MongoDB 3.6+) frames carrying BSON command documents over a
plain TCP socket, ``find`` with ``_id``-range filters for partitioned
parallel reads and ``getMore`` for cursor batches.

The BSON subset covers the types a read path round-trips: double,
string, document, array, binary, ObjectId, bool, UTC datetime (surfaced
as int64 millis), null, int32, int64; Decimal128 and timestamp surface as
raw bytes and a u64, a regex as a (pattern, options) tuple.

A read task's documents become a numpy block (``_to_block``), with the
rules the JAX package's Arrow table follows: an ObjectId becomes its hex,
a document or a tuple its ``repr``, a column's type is what Arrow would
infer from its values (ints and floats widen to float, strings and bytes
to bytes), and a column whose values Arrow could not hold in one type
becomes strings.  A missing field is None in an object column.  It is
the one connector that needs nothing beyond numpy, so it runs on the
card's host.

Read: ``ray_tpu_torch.data.read_mongo(uri, database, collection, ...)``:
partition bounds come from one ``find`` on each extreme ``_id``, then
each read task runs its own range query on its own connection.
"""

from __future__ import annotations

import functools
import socket
import struct
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.data.block import Block

# ---------------------------------------------------------------------
# BSON (subset) — https://bsonspec.org
# ---------------------------------------------------------------------

_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


@functools.total_ordering
class ObjectId:
    """12-byte document id; totally ordered by big-endian byte order."""

    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        if len(raw) != 12:
            raise ValueError("ObjectId is 12 bytes")
        self.raw = raw

    def __repr__(self):
        return f"ObjectId({self.raw.hex()})"

    def __eq__(self, other):
        return isinstance(other, ObjectId) and self.raw == other.raw

    def __lt__(self, other):
        return self.raw < other.raw

    def __hash__(self):
        return hash(self.raw)


def _enc_cstr(s: str) -> bytes:
    b = s.encode("utf-8")
    if b"\x00" in b:
        raise ValueError("embedded NUL in key")
    return b + b"\x00"


def _enc_value(key: str, v: Any) -> bytes:
    k = _enc_cstr(key)
    if isinstance(v, bool):  # before int: bool is an int subclass
        return b"\x08" + k + (b"\x01" if v else b"\x00")
    if isinstance(v, float):
        return b"\x01" + k + _F64.pack(v)
    if isinstance(v, str):
        b = v.encode("utf-8") + b"\x00"
        return b"\x02" + k + _I32.pack(len(b)) + b
    if isinstance(v, dict):
        return b"\x03" + k + encode_document(v)
    if isinstance(v, (list, tuple)):
        doc = {str(i): item for i, item in enumerate(v)}
        return b"\x04" + k + encode_document(doc)
    if isinstance(v, (bytes, bytearray)):
        return b"\x05" + k + _I32.pack(len(v)) + b"\x00" + bytes(v)
    if isinstance(v, ObjectId):
        return b"\x07" + k + v.raw
    if v is None:
        return b"\x0a" + k
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + k + _I32.pack(v)
        return b"\x12" + k + _I64.pack(v)
    raise TypeError(f"cannot BSON-encode {type(v).__name__}")


def encode_document(doc: Dict[str, Any]) -> bytes:
    body = b"".join(_enc_value(k, v) for k, v in doc.items())
    return _I32.pack(len(body) + 5) + body + b"\x00"


def _dec_cstr(buf: memoryview, pos: int) -> Tuple[str, int]:
    end = pos
    while buf[end] != 0:
        end += 1
    return bytes(buf[pos:end]).decode("utf-8"), end + 1


def decode_document(buf, pos: int = 0) -> Tuple[Dict[str, Any], int]:
    buf = memoryview(buf)
    (size,) = _I32.unpack_from(buf, pos)
    end = pos + size
    pos += 4
    out: Dict[str, Any] = {}
    while pos < end - 1:
        tag = buf[pos]
        pos += 1
        key, pos = _dec_cstr(buf, pos)
        if tag == 0x01:
            (out[key],) = _F64.unpack_from(buf, pos)
            pos += 8
        elif tag == 0x02:
            (n,) = _I32.unpack_from(buf, pos)
            out[key] = bytes(buf[pos + 4:pos + 4 + n - 1]).decode("utf-8")
            pos += 4 + n
        elif tag == 0x03:
            out[key], pos = decode_document(buf, pos)
        elif tag == 0x04:
            arr_doc, pos = decode_document(buf, pos)
            out[key] = list(arr_doc.values())
        elif tag == 0x05:
            (n,) = _I32.unpack_from(buf, pos)
            out[key] = bytes(buf[pos + 5:pos + 5 + n])
            pos += 5 + n
        elif tag == 0x07:
            out[key] = ObjectId(bytes(buf[pos:pos + 12]))
            pos += 12
        elif tag == 0x08:
            out[key] = buf[pos] != 0
            pos += 1
        elif tag == 0x09:  # UTC datetime: surfaced as int64 millis
            (out[key],) = _I64.unpack_from(buf, pos)
            pos += 8
        elif tag == 0x0A:
            out[key] = None
        elif tag == 0x0B:  # regex: two cstrings, surfaced as a tuple
            pat, pos = _dec_cstr(buf, pos)
            opts, pos = _dec_cstr(buf, pos)
            out[key] = (pat, opts)
        elif tag == 0x10:
            (out[key],) = _I32.unpack_from(buf, pos)
            pos += 4
        elif tag == 0x11:  # timestamp: surfaced as raw u64
            (out[key],) = struct.unpack_from("<Q", buf, pos)
            pos += 8
        elif tag == 0x12:
            (out[key],) = _I64.unpack_from(buf, pos)
            pos += 8
        elif tag == 0x13:  # Decimal128: surfaced as raw 16 bytes
            out[key] = bytes(buf[pos:pos + 16])
            pos += 16
        else:
            raise ValueError(f"unsupported BSON tag 0x{tag:02x} "
                             f"for key {key!r}")
    return out, end


# ---------------------------------------------------------------------
# OP_MSG transport
# ---------------------------------------------------------------------

_OP_MSG = 2013
_HDR = struct.Struct("<iiii")  # messageLength, requestID, responseTo, opCode


class MongoWire:
    """One connection speaking OP_MSG command round trips."""

    def __init__(self, host: str, port: int = 27017,
                 timeout: float = 30.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._req_id = 0

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("mongod closed the connection")
            buf += chunk
        return buf

    def command(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """One OP_MSG round trip; raises on {ok: 0} replies."""
        self._req_id += 1
        body = b"\x00" + encode_document(doc)  # flags=0, section kind 0
        msg = _HDR.pack(16 + 4 + len(body), self._req_id, 0, _OP_MSG)
        msg += b"\x00\x00\x00\x00" + body  # flagBits
        self._sock.sendall(msg)
        (length, _rid, _rto, opcode) = _HDR.unpack(self._recv_exact(16))
        payload = self._recv_exact(length - 16)
        if opcode != _OP_MSG:
            raise ValueError(f"unexpected reply opcode {opcode}")
        if payload[4] != 0:
            raise ValueError("unsupported OP_MSG reply section kind")
        reply, _ = decode_document(payload, 5)
        if not reply.get("ok"):
            raise RuntimeError(
                f"mongod error: {reply.get('errmsg', reply)}")
        return reply

    def find(self, db: str, collection: str,
             filter: Optional[dict] = None,
             projection: Optional[dict] = None,
             sort: Optional[dict] = None, limit: int = 0,
             batch_size: int = 1000) -> Iterator[dict]:
        """Stream matching documents (find + getMore)."""
        cmd: Dict[str, Any] = {"find": collection, "$db": db,
                               "batchSize": batch_size}
        if filter:
            cmd["filter"] = filter
        if projection:
            cmd["projection"] = projection
        if sort:
            cmd["sort"] = sort
        if limit:
            cmd["limit"] = limit
        reply = self.command(cmd)
        cursor = reply["cursor"]
        yield from cursor["firstBatch"]
        cid = cursor["id"]
        while cid:
            reply = self.command({"getMore": cid, "$db": db,
                                  "collection": collection,
                                  "batchSize": batch_size})
            cursor = reply["cursor"]
            yield from cursor["nextBatch"]
            cid = cursor["id"]


def parse_uri(uri: str) -> Tuple[str, int]:
    """host, port from mongodb://host[:port][/...].

    Credentials and multi-host replica-set lists are NOT supported by
    this wire client — fail up front with a clear error rather than
    connecting unauthenticated or misparsing a host list."""
    if uri.startswith("mongodb://"):
        uri = uri[len("mongodb://"):]
    hostpart = uri.split("/", 1)[0]
    if "@" in hostpart:
        raise ValueError(
            "read_mongo's wire client does not support authentication "
            "credentials in the URI; connect to an auth-free endpoint "
            "(e.g. a local replica / tunnel)")
    if "," in hostpart:
        raise ValueError(
            "read_mongo's wire client takes a single host, not a "
            "replica-set list; point it at one member")
    if ":" in hostpart:
        host, port_s = hostpart.rsplit(":", 1)
        return host, int(port_s)
    return hostpart, 27017


# ---------------------------------------------------------------------
# Documents to a numpy block
# ---------------------------------------------------------------------

class _Mixed(Exception):
    """The values hold types that no one Arrow type holds."""


_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
# Arrow's inference order: the first kind seen among the values wins
_PRIORITY = ("list", "dict", "float", "int", "bytes", "str", "bool")
_KIND = {"list": "list", "dict": "struct", "float": "double", "int": "int64",
         "bytes": "binary", "str": "string", "bool": "bool"}


def _kind_of(v: Any) -> str:
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float"
    if isinstance(v, str):
        return "str"
    if isinstance(v, (bytes, bytearray)):
        return "bytes"
    if isinstance(v, (list, tuple)):
        return "list"
    if isinstance(v, dict):
        return "dict"
    raise _Mixed(type(v).__name__)


def _infer(seqs: List[List[Any]], stop=("bool",)):
    """The Arrow type ``pyarrow.array`` infers for the values of ``seqs``
    (the column is one sequence; a list column's children are each list),
    as a kind: "null", "bool", "int64", "double", "string", "binary",
    ("list", kind) or ("struct", ((field, kind), ...)).  As in Arrow, a
    sequence's scan stops at its first bool (a list's also at its first
    string), and the kind is the first of ``_PRIORITY`` that the scans
    saw; ``_convert`` then fails where a value does not fit it."""
    seen = set()
    for seq in seqs:
        for v in seq:
            if v is None:
                continue
            k = _kind_of(v)
            seen.add(k)
            if k in stop:
                break
    for nested in ("list", "dict"):
        if nested in seen and len(seen) > 1:
            raise _Mixed(sorted(seen))  # Arrow: "cannot mix list and ..."
    top = next((k for k in _PRIORITY if k in seen), None)
    if top is None:
        return "null"
    values = [v for seq in seqs for v in seq if v is not None]
    if top == "list":
        return ("list", _infer([v for v in values
                                if isinstance(v, (list, tuple))],
                               ("bool", "str")))
    if top == "dict":
        dicts = [v for v in values if isinstance(v, dict)]
        names: List[str] = []
        for d in dicts:
            names.extend(k for k in d if k not in names)
        return ("struct", tuple(
            (k, _infer([[d[k]] for d in dicts if k in d])) for k in names))
    return _KIND[top]


# the Python kinds each Arrow kind converts
_ACCEPTS = {"double": {"float", "int", "bool"}, "int64": {"int"},
            "bool": {"bool"}, "binary": {"bytes", "str"},
            "string": {"str", "bytes"}}


def _convert(v: Any, kind):
    """``v`` as Arrow's ``to_pylist`` gives it back under ``kind``;
    raises ``_Mixed`` where Arrow's conversion fails."""
    if v is None:
        return None
    k = _kind_of(v)
    if isinstance(kind, tuple):
        if kind[0] == "list" and k == "list":
            return [_convert(x, kind[1]) for x in v]
        if kind[0] == "struct" and k == "dict":
            return {f: _convert(v.get(f), sub) for f, sub in kind[1]}
        raise _Mixed(k)
    if k not in _ACCEPTS.get(kind, ()):
        raise _Mixed(k)
    if kind == "double":
        return float(v)
    if kind == "binary":
        return v.encode("utf-8") if k == "str" else bytes(v)
    if kind == "string" and k == "bytes":
        return bytes(v).decode("utf-8")  # raises as Arrow does
    if kind == "int64" and not _I64_MIN <= v <= _I64_MAX:
        raise OverflowError("Python int too large to convert to C long")
    return v


_NUMPY = {"bool": np.bool_, "int64": np.int64, "double": np.float64}


def _column(values: List[Any]) -> np.ndarray:
    try:
        kind = _infer([values])
        values = [_convert(v, kind) for v in values]
    except _Mixed:
        # schemaless collection: a field holds different BSON types
        # across documents — that column degrades to strings rather than
        # failing the read task, as in the JAX package
        kind = "string"
        values = [None if v is None else str(v) for v in values]
    if kind in _NUMPY and None not in values:
        return np.asarray(values, dtype=_NUMPY[kind])
    if kind == "string" and None not in values:
        return np.asarray(values, dtype=str)
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _to_block(docs: List[dict]) -> Block:
    keys: List[str] = []
    for d in docs:
        keys.extend(k for k in d if k not in keys)
    block: Block = {}
    for k in keys:
        col = []
        for d in docs:
            v = d.get(k)
            if isinstance(v, ObjectId):
                v = v.raw.hex()
            elif isinstance(v, (dict, tuple)):
                v = repr(v)
            col.append(v)
        block[k] = _column(col)
    return block


# ---------------------------------------------------------------------
# Read tasks
# ---------------------------------------------------------------------

def mongo_tasks(uri: str, database: str, collection: str,
                parallelism: int,
                filter: Optional[dict] = None,
                projection: Optional[dict] = None,
                batch_size: int = 1000) -> List[Callable]:
    """Partitioned read tasks: `_id`-range slices of the collection.

    Planning runs two 1-document finds for the extreme `_id`s, then cuts
    the ObjectId space into ``parallelism`` even byte-ranges — the same
    strategy Ray's datasource delegates to pymongoarrow's partitioner."""
    host, port = parse_uri(uri)
    conn = MongoWire(host, port)
    try:
        lo = list(conn.find(database, collection, filter=filter,
                            projection={"_id": 1}, sort={"_id": 1},
                            limit=1))
        hi = list(conn.find(database, collection, filter=filter,
                            projection={"_id": 1}, sort={"_id": -1},
                            limit=1))
    finally:
        conn.close()
    if not lo or not hi:
        return []
    lo_id, hi_id = lo[0]["_id"], hi[0]["_id"]
    n = max(1, parallelism)
    bounds: List[Tuple[Any, Any]] = []
    if isinstance(lo_id, ObjectId) and isinstance(hi_id, ObjectId) and n > 1:
        lo_i = int.from_bytes(lo_id.raw, "big")
        hi_i = int.from_bytes(hi_id.raw, "big")
        cuts = [lo_i + (hi_i - lo_i) * i // n for i in range(n + 1)]
        edges = [ObjectId(c.to_bytes(12, "big")) for c in cuts]
        bounds = list(zip(edges[:-1], edges[1:]))
    else:
        bounds = [(lo_id, hi_id)]

    def make_task(lo_b, hi_b, last: bool):
        def task() -> Iterator[Block]:
            rng: Dict[str, Any] = {"$gte": lo_b}
            rng["$lte" if last else "$lt"] = hi_b
            if filter and "_id" in filter:
                # never clobber a user _id predicate ($in/$ne/...): AND
                # the partition range with the whole filter instead
                q: Dict[str, Any] = {"$and": [dict(filter),
                                              {"_id": rng}]}
            else:
                q = dict(filter or {})
                q["_id"] = rng
            c = MongoWire(host, port)
            try:
                docs = list(c.find(database, collection, filter=q,
                                   projection=projection,
                                   batch_size=batch_size))
            finally:
                c.close()
            if docs:
                yield _to_block(docs)
        return task

    return [make_task(lo_b, hi_b, i == len(bounds) - 1)
            for i, (lo_b, hi_b) in enumerate(bounds)]
