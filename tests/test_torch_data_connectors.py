"""The port's data connectors held to the JAX package's on the CPU.

Each case of ``tests/test_data_extras.py`` that reads through a connector
(MongoDB over its wire protocol, Iceberg, Delta Sharing, audio, video)
and the gated cloud readers is written once as a function of the package
under test.  It runs under the JAX package's session cluster
(``ray_cluster``) and under the port's runtime, started by a module
fixture in the same process, on the same inputs made from a numpy seed
(files, documents, a local server), makes its JAX test's assertions in
both and returns what it read as plain Python values; the two results
must be equal, floats within ``FLOAT_TOL``.

Beyond the JAX tests: BSON encodes and decodes alike both ways between
the packages, every type the JAX codec handles; a MongoDB read task's
documents become rows equal to the JAX package's Arrow table's over
seeded documents of mixed types; the servers see the same commands from
both packages (the same ``_id``-range plan); the WAV widths 8/16/24/32
and float; BI_RGB frames; Iceberg's delete-manifest errors.
"""

import concurrent.futures
import http.server
import io
import json
import os
import random
import shutil
import socket
import struct
import sys
import threading
import types
import wave

import cloudpickle
import numpy as np
import pytest
import torch

# functions defined here run in worker processes that cannot import this
# module: pickle them by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 120
SEED = 43
FLOAT_TOL = 1e-6


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
    import ray_tpu.data.mongo
    import ray_tpu_torch
    import ray_tpu_torch.data
    import ray_tpu_torch.data.mongo

    return {"jax": types.SimpleNamespace(name="jax", rt=ray_tpu,
                                         rd=ray_tpu.data,
                                         mongo=ray_tpu.data.mongo),
            "torch": types.SimpleNamespace(name="torch", rt=ray_tpu_torch,
                                           rd=ray_tpu_torch.data,
                                           mongo=ray_tpu_torch.data.mongo)}


def _plain(v):
    """Plain Python values: arrays and numpy scalars to lists and Python
    numbers, recursively, a NaN as the string "nan"."""
    if isinstance(v, float) and v != v:
        return "nan"
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            return [_plain(x) for x in v.tolist()]
        return _plain(v.tolist())
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


def _close(a, b) -> bool:
    """Equal plain values, floats within FLOAT_TOL."""
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= FLOAT_TOL
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_close, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _message(exc, tmp) -> str:
    """An error's own message: the last line of what a remote error
    carries (the traceback before it names each package's files), with
    the scenario's directory written as <tmp>."""
    return str(exc).strip().splitlines()[-1].replace(tmp, "<tmp>")


def _bounded(fn, *args):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(fn, *args).result(timeout=TIMEOUT)


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# MongoDB


def _fake_mongod(M, docs, log):
    """``tests/test_data_extras.py``'s in-process mongod (OP_MSG find and
    getMore) on codec module ``M``, appending every command it decodes to
    ``log``."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    port = srv.getsockname()[1]
    cursors = {}
    next_cursor = [1000]
    lock = threading.Lock()

    def match(doc, flt):
        for k, cond in (flt or {}).items():
            if k == "$and":
                if not all(match(doc, f) for f in cond):
                    return False
                continue
            v = doc.get(k)
            if isinstance(cond, dict):
                for op, bound in cond.items():
                    if op == "$gte" and not (v >= bound):
                        return False
                    if op == "$lt" and not (v < bound):
                        return False
                    if op == "$lte" and not (v <= bound):
                        return False
            elif v != cond:
                return False
        return True

    def serve(conn):
        try:
            while True:
                hdr = b""
                while len(hdr) < 16:
                    c = conn.recv(16 - len(hdr))
                    if not c:
                        return
                    hdr += c
                length, rid, _, _ = struct.unpack("<iiii", hdr)
                body = b""
                while len(body) < length - 16:
                    body += conn.recv(length - 16 - len(body))
                cmd, _ = M.decode_document(body, 5)
                with lock:
                    log.append(cmd)
                if "find" in cmd:
                    rows = [d for d in docs if match(d, cmd.get("filter"))]
                    if "sort" in cmd:
                        key, direction = next(iter(cmd["sort"].items()))
                        rows.sort(key=lambda d: d[key],
                                  reverse=direction < 0)
                    if cmd.get("projection"):
                        keep = [k for k, v in cmd["projection"].items()
                                if v]
                        rows = [{k: d[k] for k in keep if k in d}
                                for d in rows]
                    if cmd.get("limit"):
                        rows = rows[:cmd["limit"]]
                    bs = cmd.get("batchSize", 101)
                    first, rest = rows[:bs], rows[bs:]
                    cid = 0
                    if rest:
                        with lock:
                            cid = next_cursor[0]
                            next_cursor[0] += 1
                            cursors[cid] = (rest, cmd["find"])
                    reply = {"cursor": {"firstBatch": first, "id": cid,
                                        "ns": f"{cmd['$db']}.{cmd['find']}"},
                             "ok": 1.0}
                elif "getMore" in cmd:
                    with lock:
                        rest, coll = cursors.pop(cmd["getMore"], ([], ""))
                    bs = cmd.get("batchSize", 101)
                    batch, rest = rest[:bs], rest[bs:]
                    cid = 0
                    if rest:
                        with lock:
                            cid = next_cursor[0]
                            next_cursor[0] += 1
                            cursors[cid] = (rest, coll)
                    reply = {"cursor": {"nextBatch": batch, "id": cid,
                                        "ns": f"{cmd['$db']}.{coll}"},
                             "ok": 1.0}
                else:
                    reply = {"ok": 0.0, "errmsg": "unknown command"}
                payload = b"\x00\x00\x00\x00\x00" + M.encode_document(reply)
                conn.sendall(struct.pack("<iiii", 16 + len(payload), 1,
                                         rid, 2013) + payload)
        except OSError:
            pass
        finally:
            conn.close()

    def accept_loop():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=serve, args=(c,), daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()
    return srv, port


def _oid_plain(v):
    """Commands and documents as plain values: an ObjectId as its hex."""
    if type(v).__name__ == "ObjectId":
        return "oid:" + v.raw.hex()
    if isinstance(v, dict):
        return {k: _oid_plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_oid_plain(x) for x in v]
    return v


def _mongo_docs(M, n=50):
    """The JAX test's 50 documents, with a schemaless field (ints in some
    documents, strings in others), a field some documents lack, and a
    nested document, from SEED."""
    rng = np.random.default_rng(SEED)
    docs = []
    for i in range(n):
        d = {"_id": M.ObjectId((i * 7919).to_bytes(12, "big")), "x": i,
             "name": f"row-{i}", "score": i * 1.5,
             "mixed": int(rng.integers(0, 9)) if i % 3 else f"s{i}",
             "tags": [f"t{k}" for k in range(i % 4)],
             "meta": {"k": i, "b": bytes(rng.integers(0, 255, 2,
                                                    dtype=np.uint8))}}
        if i % 5:
            d["opt"] = float(rng.standard_normal())
        docs.append(d)
    return docs


@scenario
def read_mongo_wire_protocol(p, tmp):
    M = p.mongo
    log = []
    srv, port = _fake_mongod(M, _mongo_docs(M), log)
    uri = f"mongodb://127.0.0.1:{port}"
    try:
        ds = p.rd.read_mongo(uri, "testdb", "events", override_num_blocks=4)
        rows = sorted(ds.take_all(), key=lambda r: r["x"])
        assert len(rows) == 50
        assert rows[7]["name"] == "row-7"
        assert rows[49]["score"] == 73.5
        # filtered + projected read
        ds2 = p.rd.read_mongo(uri, "testdb", "events",
                              filter={"x": {"$gte": 40}},
                              projection={"_id": 1, "x": 1},
                              override_num_blocks=2)
        few = sorted(ds2.take_all(), key=lambda r: r["x"])
        assert len(few) == 10
    finally:
        srv.close()
    assert {type(r["mixed"]) for r in rows} == {str}  # schemaless: strings
    return (_rows(rows), _rows(few),
            sorted(json.dumps(_oid_plain(c), sort_keys=True) for c in log))


# ---------------------------------------------------------------------------
# Iceberg


def _write_iceberg_table(root, rows_per_file, delete_manifest=False,
                         delete_file=False):
    """A minimal Iceberg v2 table (``tests/test_data_extras.py``'s):
    metadata json + Avro manifest chain + parquet data files, two
    snapshots (98 holds the first file only)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ray_tpu.data.datasource import write_avro_file

    meta_dir = os.path.join(root, "metadata")
    data_dir = os.path.join(root, "data")
    os.makedirs(meta_dir)
    os.makedirs(data_dir)
    data_files = []
    for i, rows in enumerate(rows_per_file):
        p = os.path.join(data_dir, f"part-{i}.parquet")
        pq.write_table(pa.table(rows), p)
        data_files.append(p)

    entry_schema = {
        "type": "record", "name": "manifest_entry", "fields": [
            {"name": "status", "type": "int"},
            {"name": "data_file", "type": {
                "type": "record", "name": "r2", "fields": [
                    {"name": "content", "type": "int"},
                    {"name": "file_path", "type": "string"},
                    {"name": "record_count", "type": "long"},
                ]}},
        ]}
    mlist_schema = {
        "type": "record", "name": "manifest_file", "fields": [
            {"name": "manifest_path", "type": "string"},
            {"name": "content", "type": "int"},
        ]}
    snapshots = []
    for snap, files in ((98, data_files[:1]), (99, data_files)):
        manifest = os.path.join(meta_dir, f"manifest-{snap}.avro")
        entries = [{"status": 1,
                    "data_file": {"content": 0, "file_path": "file://" + p,
                                  "record_count": 2}} for p in files]
        entries.append({"status": 2, "data_file": {  # a DELETED entry
            "content": 0, "file_path": "file:///gone.parquet",
            "record_count": 2}})
        if delete_file:
            entries.append({"status": 1, "data_file": {
                "content": 1, "file_path": "file:///pos-deletes.parquet",
                "record_count": 1}})
        write_avro_file(entries, manifest, schema=entry_schema)
        mlist = os.path.join(meta_dir, f"snap-{snap}.avro")
        manifests = [{"manifest_path": "file://" + manifest, "content": 0}]
        if delete_manifest:
            manifests.append({"manifest_path": "file://" + manifest,
                              "content": 1})
        write_avro_file(manifests, mlist, schema=mlist_schema)
        snapshots.append({"snapshot-id": snap,
                          "manifest-list": "file://" + mlist})
    meta = {"format-version": 2, "location": "file://" + root,
            "current-snapshot-id": 99, "snapshots": snapshots}
    with open(os.path.join(meta_dir, "v1.metadata.json"), "w") as fh:
        json.dump(meta, fh)
    with open(os.path.join(meta_dir, "version-hint.text"), "w") as fh:
        fh.write("1")


def _iceberg_rows():
    rng = np.random.default_rng(SEED)
    return [{"x": [1, 2], "s": ["a", "b"],
             "f": rng.standard_normal(2).tolist()},
            {"x": [3, 4], "s": ["c", "d"],
             "f": rng.standard_normal(2).tolist()}]


@scenario
def read_iceberg_native(p, tmp):
    root = os.path.join(tmp, "ice_tbl")
    _write_iceberg_table(root, _iceberg_rows())
    rows = sorted(p.rd.read_iceberg(root).take_all(), key=lambda r: r["x"])
    assert [r["x"] for r in rows] == [1, 2, 3, 4]
    assert rows[2]["s"] == "c"
    # column pruning + explicit snapshot ids
    cols = p.rd.read_iceberg(root, snapshot_id=99, columns=["x"]).take_all()
    assert all(set(r) == {"x"} for r in cols)
    old = p.rd.read_iceberg(root, snapshot_id=98).take_all()
    with pytest.raises(ValueError) as missing:
        p.rd.read_iceberg(root, snapshot_id=12345).take_all()
    return (_rows(rows), _rows(cols, key=lambda r: r["x"]),
            _rows(old, key=lambda r: r["x"]),
            _message(missing.value, tmp))


@scenario
def read_iceberg_relocated_table(p, tmp):
    orig = os.path.join(tmp, "orig")
    _write_iceberg_table(orig, [{"x": [7, 8]}])
    moved = os.path.join(tmp, "elsewhere", "tbl")
    shutil.copytree(orig, moved)
    shutil.rmtree(orig)  # recorded URIs now dangle
    rows = p.rd.read_iceberg(moved).take_all()
    assert sorted(r["x"] for r in rows) == [7, 8]
    return _rows(rows, key=lambda r: r["x"])


@scenario
def iceberg_delete_files_are_refused(p, tmp):
    errors = []
    for kind in ("delete_manifest", "delete_file"):
        root = os.path.join(tmp, kind)
        _write_iceberg_table(root, [{"x": [1]}], **{kind: True})
        with pytest.raises(NotImplementedError) as ei:
            p.rd.read_iceberg(root)
        errors.append(_message(ei.value, tmp))
    return errors


# ---------------------------------------------------------------------------
# Delta Sharing


def _delta_server(tmp):
    """An in-process sharing server (``tests/test_data_extras.py``'s):
    the table query answers NDJSON file entries whose URLs serve
    parquet; the files lack the partition columns."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(SEED)
    blobs = []
    for lo in (0, 50):
        t = pa.table({"x": list(range(lo, lo + 50)),
                      "tag": [f"r{v}" for v in range(lo, lo + 50)],
                      "w": rng.standard_normal(50)})
        buf = io.BytesIO()
        pq.write_table(t, buf)
        blobs.append(buf.getvalue())
    partitions = [{"region": "r0", "day": "1", "hot": "true",
                   "frac": "0.25", "odd": None},
                  {"region": "r1", "day": "2", "hot": "false",
                   "frac": "1.5", "odd": "7"}]

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            assert self.path.endswith(
                "/shares/sales/schemas/q1/tables/orders/query")
            assert self.headers["Authorization"] == "Bearer tok-123"
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            base = f"http://127.0.0.1:{self.server.server_port}"
            schema_str = json.dumps({"type": "struct", "fields": [
                {"name": "x", "type": "long"},
                {"name": "tag", "type": "string"},
                {"name": "w", "type": "double"},
                {"name": "region", "type": "string"},
                {"name": "day", "type": "integer"},
                {"name": "hot", "type": "boolean"},
                {"name": "frac", "type": "float"},
                {"name": "odd", "type": "short"}]})
            lines = [json.dumps({"protocol": {"minReaderVersion": 1}}),
                     json.dumps({"metaData": {
                         "id": "tbl", "schemaString": schema_str,
                         "partitionColumns": list(partitions[0])}})]
            for i in range(len(blobs)):
                lines.append(json.dumps(
                    {"file": {"url": f"{base}/data/{i}.parquet",
                              "id": str(i),
                              "partitionValues": partitions[i]}}))
            body = ("\n".join(lines)).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            idx = int(self.path.rsplit("/", 1)[1].split(".")[0])
            self.send_response(200)
            self.send_header("Content-Length", str(len(blobs[idx])))
            self.end_headers()
            self.wfile.write(blobs[idx])

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    profile = os.path.join(tmp, "profile.json")
    with open(profile, "w") as f:
        json.dump({"shareCredentialsVersion": 1,
                   "endpoint": f"http://127.0.0.1:{srv.server_port}",
                   "bearerToken": "tok-123"}, f)
    return srv, profile


@scenario
def read_delta_sharing_rest_protocol(p, tmp):
    srv, profile = _delta_server(tmp)
    try:
        ds = p.rd.read_delta_sharing(f"{profile}#sales.q1.orders",
                                     override_num_blocks=2)
        rows = sorted(ds.take_all(), key=lambda r: r["x"])
        assert len(rows) == 100
        assert rows[0]["tag"] == "r0" and rows[99]["tag"] == "r99"
        # partition columns reconstructed from partitionValues with the
        # schemaString types (data files physically lack them)
        assert rows[0]["region"] == "r0" and rows[0]["day"] == 1
        assert rows[99]["region"] == "r1" and rows[99]["day"] == 2
        # limit= is enforced client-side even when the server ignores
        # the advisory limitHint (this fake server does)
        few = p.rd.read_delta_sharing(f"{profile}#sales.q1.orders",
                                      limit=7).take_all()
        assert len(few) == 7
    finally:
        srv.shutdown()
    return _rows(rows), len(few)


# ---------------------------------------------------------------------------
# Audio


def _write_wavs(d):
    """PCM WAVs of widths 1-4 bytes (mono and stereo) and IEEE-float WAVs
    (32 and 64 bit, with a JUNK chunk before fmt), from SEED."""
    rng = np.random.default_rng(SEED)
    os.makedirs(d)
    paths = []
    for width, ch in ((1, 1), (2, 1), (2, 2), (3, 2), (4, 1)):
        n = 40 + width
        p = os.path.join(d, f"pcm{width * 8}_{ch}.wav")
        if width == 3:
            raw = rng.integers(0, 256, n * ch * 3, dtype=np.uint8).tobytes()
        else:
            dt = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
            info = np.iinfo(dt)
            raw = rng.integers(info.min, info.max, n * ch,
                               dtype=dt).tobytes()
        with wave.open(p, "wb") as w:
            w.setnchannels(ch)
            w.setsampwidth(width)
            w.setframerate(8000 * width)
            w.writeframes(raw)
        paths.append(p)
    for bits, dt in ((32, "<f4"), (64, "<f8")):
        ch, n, rate = 2, 33, 22050
        data = rng.uniform(-1, 1, n * ch).astype(dt).tobytes()
        fmt = struct.pack("<HHIIHH", 3, ch, rate, rate * ch * bits // 8,
                          ch * bits // 8, bits)
        chunks = (b"JUNK" + struct.pack("<I", 5) + b"12345\x00"
                  + b"fmt " + struct.pack("<I", len(fmt)) + fmt
                  + b"data" + struct.pack("<I", len(data)) + data)
        p = os.path.join(d, f"float{bits}.wav")
        with open(p, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE"
                    + chunks)
        paths.append(p)
    return paths


@scenario
def read_audio_wav_native(p, tmp):
    d = os.path.join(tmp, "wav")
    paths = _write_wavs(d)
    rows = p.rd.read_audio(paths, override_num_blocks=3).take_all()
    assert len(rows) == len(paths)
    out = []
    for r in rows:
        amp = np.asarray(r["amplitude"], dtype=np.float32)
        assert amp.ndim == 2 and np.abs(amp).max() <= 1.0
        out.append({"path": os.path.basename(r["path"]),
                    "sample_rate": _plain(r["sample_rate"]),
                    "shape": list(amp.shape), "amplitude": amp.tolist()})
    flac = os.path.join(d, "x.flac")
    open(flac, "wb").close()
    with pytest.raises(ImportError) as ei:
        p.rd.read_audio(flac).take_all()
    return (sorted(out, key=lambda r: r["path"]),
            _message(ei.value, tmp))


# ---------------------------------------------------------------------------
# Video


def _chunk(fourcc, payload):
    pad = b"\x00" if len(payload) & 1 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _write_mjpeg_avi(path, frames):
    """``tests/test_data_extras.py``'s minimal MJPEG AVI."""
    from PIL import Image

    jpegs = []
    for arr in frames:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=95)
        jpegs.append(buf.getvalue())
    movi = b"movi" + b"".join(_chunk(b"00dc", j) for j in jpegs)
    body = b"AVI " + _chunk(b"LIST", movi)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _write_dib_avi(path, frames, height_sign=1, codec=b"\x00\x00\x00\x00"):
    """An AVI whose first stream is audio (its strf a WAVEFORMATEX) and
    whose video stream holds BI_RGB frames: BGR rows padded to 4 bytes,
    bottom-up for a positive height."""
    h, w, _ = frames[0].shape
    auds = _chunk(b"LIST", b"strl" + _chunk(b"strh", b"auds" + bytes(52))
                  + _chunk(b"strf", bytes(18)))
    bih = struct.pack("<IiiHH", 40, w, height_sign * h, 1, 24) + codec \
        + bytes(20)
    vids = _chunk(b"LIST", b"strl" + _chunk(b"strh", b"vids" + bytes(52))
                  + _chunk(b"strf", bih))
    stride = (w * 3 + 3) & ~3
    chunks = []
    for f in frames:
        rows = f[::-1] if height_sign > 0 else f
        bgr = rows[..., ::-1]
        padded = np.zeros((h, stride), np.uint8)
        padded[:, :w * 3] = bgr.reshape(h, w * 3)
        chunks.append(_chunk(b"00db", padded.tobytes()))
    body = (b"AVI " + _chunk(b"LIST", b"hdrl" + auds + vids)
            + _chunk(b"LIST", b"movi" + b"".join(chunks)))
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)


@scenario
def read_videos_avi(p, tmp):
    rng = np.random.default_rng(SEED)
    flat = [np.full((16, 24, 3), c, np.uint8) for c in (10, 120, 240)]
    mjpeg = os.path.join(tmp, "clip.avi")
    _write_mjpeg_avi(mjpeg, flat)
    rows = sorted(p.rd.read_videos(mjpeg).take_all(),
                  key=lambda r: r["frame_index"])
    assert len(rows) == 3
    for want, row in zip(flat, rows):
        got = np.asarray(row["frame"])
        assert got.shape == (16, 24, 3)
        # JPEG is lossy on flat fields only by a hair
        assert abs(int(got.mean()) - int(want.mean())) <= 3
    noisy = [rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
             for _ in range(70)]  # past one 64-frame block
    dib = {}
    for sign in (1, -1):
        path = os.path.join(tmp, f"dib{sign}.avi")
        _write_dib_avi(path, noisy, sign)
        got = sorted(p.rd.read_videos(path).take_all(),
                     key=lambda r: r["frame_index"])
        assert [r["frame_index"] for r in got] == list(range(70))
        assert all(np.array_equal(np.asarray(r["frame"]), f)
                   for r, f in zip(got, noisy))
        dib[sign] = [_plain(np.asarray(r["frame"])) for r in got[:3]]
    h264 = os.path.join(tmp, "h264.avi")
    _write_dib_avi(h264, noisy[:1], codec=b"H264")
    with pytest.raises(NotImplementedError) as ei:
        p.rd.read_videos(h264).take_all()
    return ([_plain(np.asarray(r["frame"])) for r in rows], dib,
            _message(ei.value, tmp))


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_connector_agrees_with_jax(name, ray_cluster, port, tmp_path):
    results = {}
    for pkg, p in _packages().items():
        tmp = tmp_path / pkg
        tmp.mkdir()
        results[pkg] = _plain(_bounded(SCENARIOS[name], p, str(tmp)))
    assert results["jax"] is not None
    assert _close(results["torch"], results["jax"]), name


GATED = [("read_bigquery", "google-cloud-bigquery"), ("read_hudi", "hudi"),
         ("read_lance", "pylance"),
         ("read_databricks_tables", "databricks-sql-connector")]


@pytest.mark.parametrize("name,pkg", GATED)
def test_gated_readers_raise_the_jax_packages_errors(name, pkg):
    """``tests/test_data_extras.py``'s gating: each raises naming its
    wheel (or the build's gate where the wheel is present), outside
    ``__all__``, with the JAX package's message."""
    errors = {}
    for key, p in _packages().items():
        fn = getattr(p.rd, name)
        assert name not in p.rd.__all__
        with pytest.raises((ImportError, NotImplementedError)) as ei:
            fn("whatever")
        assert pkg in str(ei.value) or "gates" in str(ei.value)
        errors[key] = (type(ei.value).__name__, str(ei.value),
                       fn.__name__, fn.__doc__)
    assert errors["torch"] == errors["jax"]


def test_the_data_packages_export_the_same_names():
    import ray_tpu.data
    import ray_tpu_torch.data

    assert set(ray_tpu.data.__all__) == set(ray_tpu_torch.data.__all__)


# ---------------------------------------------------------------------------
# BSON and documents to blocks


def _bson_doc(M):
    return {"d": -2.5, "s": "héllo", "doc": {"a": 1, "b": [True, None]},
            "arr": [1, "x", 2.0, {"k": b"\x00\x01"}], "bin": b"\xff\x00",
            "oid": M.ObjectId(bytes(range(12))), "t": True, "f": False,
            "n": None, "i32": -(1 << 31), "i64": 1 << 40,
            "i64neg": -(1 << 62), "tup": ("p", "q"), "empty": {},
            "nested": [[1, [2, [3]]], []]}


def _raw_tail():
    """Elements only the decoder meets: a UTC datetime, a regex, a
    timestamp and a Decimal128."""
    def el(tag, key, payload):
        return bytes([tag]) + key.encode() + b"\x00" + payload

    body = (el(0x09, "when", struct.pack("<q", 1_700_000_000_123))
            + el(0x0B, "re", b"^a.*b$\x00im\x00")
            + el(0x11, "ts", struct.pack("<Q", (1 << 63) + 5))
            + el(0x13, "dec", bytes(range(16))))
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def test_bson_encodes_and_decodes_alike_both_ways():
    pk = _packages()
    J, P = pk["jax"].mongo, pk["torch"].mongo
    enc_j = J.encode_document(_bson_doc(J))
    enc_p = P.encode_document(_bson_doc(P))
    assert enc_p == enc_j
    for dec in (J, P):
        for enc in (enc_j, enc_p):
            doc, end = dec.decode_document(enc)
            assert end == len(enc)
            assert _oid_plain(doc) == _oid_plain(
                J.decode_document(enc_j)[0])
    raw = _raw_tail()
    assert _oid_plain(P.decode_document(raw)) == _oid_plain(
        J.decode_document(raw))
    assert P.decode_document(raw)[0]["re"] == ("^a.*b$", "im")
    for bad in (object(), 1 << 64):
        errors = []
        for M in (J, P):
            with pytest.raises((TypeError, struct.error)) as ei:
                M.encode_document({"k": bad})
            errors.append(type(ei.value))
        assert errors[0] == errors[1]
    for M in (J, P):
        with pytest.raises(ValueError):
            M.encode_document({"a\x00b": 1})
        assert M.parse_uri("mongodb://h:1234/db") == ("h", 1234)
        assert M.parse_uri("h") == ("h", 27017)
        for uri in ("mongodb://u:p@h", "mongodb://a,b"):
            with pytest.raises(ValueError):
                M.parse_uri(uri)


_ATOMS = [None, True, False, 0, 1, -5, 1 << 40, 1.5, float("nan"), "a", "",
          b"x", b"", ("p", "i")]


def _random_value(rng, M, depth=0):
    r = rng.random()
    if r < 0.6 or depth > 2:
        v = rng.choice(_ATOMS + ["oid"])
        return M.ObjectId(b"a" * 12) if v == "oid" else v
    if r < 0.8:
        return [_random_value(rng, M, depth + 1)
                for _ in range(rng.randint(0, 3))]
    return {rng.choice("abc"): _random_value(rng, M, depth + 1)
            for _ in range(rng.randint(0, 2))}


def test_documents_become_the_jax_packages_rows():
    """A read task's documents as rows: the port's numpy block against
    the JAX package's Arrow table, over 400 seeded sets of documents of
    mixed BSON types (Arrow's inference: ints and floats widen, strings
    and bytes become bytes, a nested list or document keeps its values,
    anything Arrow refuses becomes strings)."""
    pk = _packages()
    J, P = pk["jax"].mongo, pk["torch"].mongo
    for case in range(400):
        docs = {}
        for key, M in (("jax", J), ("torch", P)):
            rng = random.Random(SEED * 1000 + case)
            docs[key] = [{k: _random_value(rng, M) for k in "xyz"
                          if rng.random() < 0.8}
                         for _ in range(rng.randint(1, 4))]
        want = J._to_table(docs["jax"]).to_pylist()
        block = P._to_block(docs["torch"])
        got = [{k: block[k][i] for k in block}
               for i in range(len(docs["torch"]))] if block else []
        assert _plain(got) == _plain(want), (case, docs["jax"])


def test_the_data_package_imports_without_torch():
    """A read task unpickled in a fresh worker imports the data package:
    that import loads no torch (on the card's host importing torch costs a
    fresh worker ~10 s), and no pyarrow or PIL."""
    import subprocess

    code = ("import sys\n"
            "import ray_tpu_torch.data, ray_tpu_torch.data.mongo\n"
            "import ray_tpu_torch.data.lakehouse, ray_tpu_torch.data.video\n"
            "import ray_tpu_torch.data.audio, ray_tpu_torch.data.delta_sharing\n"
            "print(sorted(m for m in ('torch', 'pyarrow', 'PIL')\n"
            "             if m in sys.modules))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
