"""Native Iceberg table reader.

Counterpart of ``ray_tpu/data/lakehouse.py`` (Ray's Iceberg datasource,
python/ray/data/_internal/datasource/iceberg_datasource.py, calls
pyiceberg).  The metadata chain is walked directly: JSON, then Avro
through the port's own decoder (``datasource.read_avro_rows``), then
Parquet through pyarrow, imported inside the read task as
``datasource.parquet_tasks`` does (the card's host has no pyarrow, so
this reader runs where it is installed):

    table/metadata/v{N}.metadata.json   (JSON: snapshots, schemas)
        -> snapshot.manifest-list       (Avro: one row per manifest)
        -> manifest.avro                (Avro: one row per data file)
        -> data/*.parquet               (pyarrow)

One read task per live data file, so a large table fans out across the
cluster as ``read_parquet`` on a directory does.  Scope: reads the
current (or a named) snapshot of a v1/v2 table with parquet data files;
positional/equality deletes (v2 row-level deletes) are detected and
rejected with a clear error rather than silently mis-read.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterator, List, Optional

from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data import datasource as _ds
from ray_tpu_torch.data.block import Block


def _local_path(uri: str, table_dir: str) -> str:
    """Resolve a metadata-recorded URI to a local path.

    Iceberg metadata records absolute URIs from write time; a copied or
    downloaded table lives somewhere else, so when the recorded path does
    not exist the tail of the URI is re-anchored at the actual table dir
    (matching pyiceberg's behavior for relocated file:// tables).
    """
    path = uri
    for scheme in ("file://", "s3://", "gs://", "abfs://"):
        if path.startswith(scheme):
            path = path[len(scheme):]
            if not path.startswith("/"):
                path = "/" + path
            break
    if os.path.exists(path):
        return path
    # re-anchor: .../<table>/{metadata,data}/... under table_dir
    parts = path.split("/")
    for anchor in ("metadata", "data"):
        if anchor in parts:
            idx = len(parts) - 1 - parts[::-1].index(anchor)
            cand = os.path.join(table_dir, *parts[idx:])
            if os.path.exists(cand):
                return cand
    return path  # let the open() raise a precise FileNotFoundError


def _table_metadata(table_dir: str) -> dict:
    meta_dir = os.path.join(table_dir, "metadata")
    hint = os.path.join(meta_dir, "version-hint.text")
    if os.path.exists(hint):
        with open(hint) as fh:
            v = fh.read().strip()
        path = os.path.join(meta_dir, f"v{v}.metadata.json")
    else:
        def version_of(f: str) -> int:
            # numeric sort on the LEADING digit run only: names are
            # v{N}.metadata.json or {NNNNN}-{uuid}.metadata.json, and
            # digits inside the uuid must not contaminate the version
            stem = f[:-len(".metadata.json")].lstrip("v")
            n = 0
            while n < len(stem) and stem[n].isdigit():
                n += 1
            return int(stem[:n]) if n else -1

        cands = sorted(
            (f for f in os.listdir(meta_dir)
             if f.endswith(".metadata.json")), key=version_of)
        if not cands:
            raise FileNotFoundError(
                f"no *.metadata.json under {meta_dir}: not an Iceberg table")
        path = os.path.join(meta_dir, cands[-1])
    with open(path) as fh:
        return json.load(fh)


def iceberg_tasks(table_dir: str, parallelism: int,
                  snapshot_id: Optional[int] = None,
                  columns: Optional[List[str]] = None) -> List[Callable]:
    table_dir = os.path.abspath(table_dir)
    meta = _table_metadata(table_dir)
    snapshots = meta.get("snapshots", [])
    if snapshot_id is None:
        snapshot_id = meta.get("current-snapshot-id")
    snap = next(
        (s for s in snapshots if s.get("snapshot-id") == snapshot_id), None)
    if snap is None:
        if snapshot_id in (None, -1):
            return []  # empty table: metadata exists, no snapshot yet
        raise ValueError(
            f"snapshot {snapshot_id} not found in {table_dir} "
            f"(have: {[s.get('snapshot-id') for s in snapshots]})")

    # manifest list -> manifests -> live parquet data files
    mlist = _local_path(snap["manifest-list"], table_dir)
    data_files: List[str] = []
    for mrow in _ds.read_avro_rows(mlist):
        manifest = _local_path(mrow["manifest_path"], table_dir)
        if mrow.get("content", 0) == 1:
            raise NotImplementedError(
                f"{manifest}: delete manifest (v2 row-level deletes) — "
                "compact the table (rewrite_data_files) before reading")
        for entry in _ds.read_avro_rows(manifest):
            if entry.get("status") == 2:  # DELETED entry
                continue
            df = entry.get("data_file") or {}
            if df.get("content", 0) != 0:  # position/equality deletes
                raise NotImplementedError(
                    f"{manifest}: delete files present — compact first")
            data_files.append(_local_path(df["file_path"], table_dir))

    def read_file(f: str) -> Iterator[Block]:
        import pyarrow.parquet as pq

        yield block_mod.from_arrow(pq.read_table(f, columns=columns))

    return _ds._file_tasks(data_files, parallelism, read_file)
