"""Delta Sharing datasource over the open REST protocol — no client wheel.

Counterpart of ``ray_tpu/data/delta_sharing.py`` (Ray's delta-sharing
datasource, python/ray/data/_internal/datasource/
delta_sharing_datasource.py, wraps the `delta-sharing` client).  The
protocol (github.com/delta-io/delta-sharing/blob/main/PROTOCOL.md) is a
small REST surface, spoken here with urllib:

  POST {endpoint}/shares/{share}/schemas/{schema}/tables/{table}/query
    -> NDJSON: a `protocol` line, a `metaData` line, then one `file`
       line per data file with a presigned parquet URL.

Each file becomes part of a read task that downloads its parquet bytes
and decodes them with pyarrow, imported inside ``_fetch_parquet`` (the
card's host has no pyarrow, so this reader runs where it is installed);
the partition columns the data files lack are numpy columns cast from
each file's ``partitionValues`` by the table's schema.

URL form (Ray's): ``<profile-file>#<share>.<schema>.<table>`` where the
profile file is the standard JSON ``{"endpoint": ..., "bearerToken": ...}``.
"""

from __future__ import annotations

import io
import json
import urllib.request
from typing import Callable, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block


def parse_url(url: str):
    """(profile_path, share, schema, table) from profile#share.schema.table."""
    if "#" not in url:
        raise ValueError(
            "delta-sharing URL must be '<profile-file>#share.schema.table'")
    profile_path, triple = url.rsplit("#", 1)
    parts = triple.split(".")
    if len(parts) != 3:
        raise ValueError(f"bad share triple {triple!r} "
                         "(want share.schema.table)")
    return profile_path, parts[0], parts[1], parts[2]


def load_profile(profile_path: str) -> dict:
    with open(profile_path) as f:
        prof = json.load(f)
    if "endpoint" not in prof:
        raise ValueError(f"profile {profile_path} has no endpoint")
    return prof


def query_table_files(prof: dict, share: str, schema: str, table: str,
                      limit: Optional[int] = None,
                      timeout: float = 60.0):
    """(file entries, metaData) for the table's snapshot."""
    endpoint = prof["endpoint"].rstrip("/")
    url = (f"{endpoint}/shares/{share}/schemas/{schema}"
           f"/tables/{table}/query")
    body: dict = {}
    if limit is not None:
        body["limitHint"] = int(limit)
    req = urllib.request.Request(
        url, data=json.dumps(body).encode("utf-8"), method="POST",
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {prof.get('bearerToken', '')}"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        lines = resp.read().decode("utf-8").splitlines()
    files = []
    meta = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        entry = json.loads(line)
        if "file" in entry:
            files.append(entry["file"])
        elif "metaData" in entry:
            meta = entry["metaData"]
    return files, meta


# a Spark schema's simple types as numpy dtypes (the JAX package maps them
# to the Arrow types of the same widths)
_SIMPLE = {"long": np.dtype(np.int64), "integer": np.dtype(np.int32),
           "short": np.dtype(np.int16), "byte": np.dtype(np.int8),
           "double": np.dtype(np.float64), "float": np.dtype(np.float32),
           "boolean": np.dtype(np.bool_), "string": np.dtype(str)}


def _partition_types(meta: dict) -> dict:
    """partition column -> numpy dtype, from metaData.schemaString (a
    Spark schema).  Unknown/complex types surface as strings."""
    out = {}
    try:
        fields = json.loads(meta.get("schemaString", "{}")).get("fields", [])
        for f in fields:
            t = f.get("type")
            if isinstance(t, str) and t in _SIMPLE:
                out[f.get("name")] = _SIMPLE[t]
    except (ValueError, AttributeError):
        pass
    return out


def _cast_partition(value, typ: np.dtype):
    if value is None:
        return None
    if typ.kind == "b":
        return value in ("true", "True", True)
    if typ.kind == "i":
        return int(value)
    if typ.kind == "f":
        return float(value)
    return str(value)


def _partition_column(value, typ: np.dtype, n: int) -> np.ndarray:
    """``n`` rows of one partition value cast to ``typ``; a null partition
    is None in an object column."""
    cast = _cast_partition(value, typ)
    if cast is None:
        return np.full(n, None, dtype=object)
    if typ.kind == "U":
        return np.asarray([cast] * n, dtype=str)
    return np.full(n, cast, dtype=typ)


def _fetch_parquet(url: str, partition_values: Optional[dict] = None,
                   ptypes: Optional[dict] = None,
                   timeout: float = 120.0) -> Block:
    import pyarrow.parquet as pq

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        raw = resp.read()
    block = block_mod.from_arrow(pq.read_table(io.BytesIO(raw)))
    n = block_mod.num_rows(block)
    # Delta data files physically LACK partition columns: the protocol
    # requires clients to reconstruct them from each file entry's
    # partitionValues (Ray's client does the same).
    for col, sval in (partition_values or {}).items():
        if col in block:
            continue
        typ = (ptypes or {}).get(col, np.dtype(str))
        block[col] = _partition_column(sval, typ, n)
    return block


def delta_sharing_tasks(url: str, parallelism: int,
                        limit: Optional[int] = None) -> List[Callable]:
    profile_path, share, schema, table = parse_url(url)
    prof = load_profile(profile_path)
    files, meta = query_table_files(prof, share, schema, table,
                                    limit=limit)
    ptypes = _partition_types(meta)

    def make_task(batch: List[dict]):
        def task() -> Iterator[Block]:
            for f in batch:
                yield _fetch_parquet(f["url"],
                                     f.get("partitionValues"), ptypes)
        return task

    n = max(1, min(parallelism, len(files))) if files else 0
    buckets: List[List[dict]] = [[] for _ in range(n)]
    for i, f in enumerate(files):
        buckets[i % n].append(f)
    return [make_task(b) for b in buckets if b]
