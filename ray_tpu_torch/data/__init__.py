"""Data: lazy, streaming, distributed datasets over numpy blocks.

Counterpart of ``ray_tpu.data`` (Ray Data, python/ray/data/) on the
port's runtime: the constructors build a lazy logical plan, transforms
append ops, and consumption lowers it to physical operators run by a
pull-based streaming executor on the runtime's tasks and actors
(``dataset.py``, ``executor.py``).  Blocks are ``{column: ndarray}``
(``block.py``), where the JAX package's are pyarrow tables.  The readers
build their read tasks in ``datasource.py``; ``service`` is the data
service, one shared input tier that trainers attach to.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ray_tpu_torch.data import block as _block
from ray_tpu_torch.data import datasource as _ds
from ray_tpu_torch.data import logical as _L
from ray_tpu_torch.data.block import Block, BlockMetadata
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset, GroupedData, MaterializedDataset
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.preprocessor import (
    Chain,
    Concatenator,
    LabelEncoder,
    MinMaxScaler,
    OneHotEncoder,
    Preprocessor,
    SimpleImputer,
    StandardScaler,
)
from ray_tpu_torch.data import service  # noqa: E402 — the data service


def _read(name: str, tasks) -> Dataset:
    return Dataset(_L.LogicalPlan([_L.Read(name=name, read_tasks=tasks)]))


def _par(override: Optional[int]) -> int:
    return override or DataContext.get_current().default_parallelism


def range(n: int, *,  # noqa: A001 — the JAX package's name
          override_num_blocks: Optional[int] = None) -> Dataset:
    """Rows ``{"id": i}`` for i in [0, n), int64, in evenly split blocks."""
    return _read("Range", _ds.range_tasks(n, _par(override_num_blocks)))


def from_items(items: List[Any], *,
               override_num_blocks: Optional[int] = None) -> Dataset:
    """One row per item (dicts by key, anything else as ``"item"``)."""
    return _read("FromItems", _ds.items_tasks(items, _par(override_num_blocks)))


def _input(block: Block, name: str) -> Dataset:
    """One block, put to the store now (an initialised runtime is
    needed)."""
    import ray_tpu_torch as rt

    bundles = [(rt.put(block), BlockMetadata.of(block))]
    return Dataset(_L.LogicalPlan([_L.InputData(name=name,
                                                bundles=bundles)]))


def from_numpy(arr, column: str = "item") -> Dataset:
    """One block holding ``arr`` as one column, its rows along axis 0."""
    import numpy as np

    return _input(_block.from_batch({column: np.asarray(arr)}), "FromNumpy")


def from_pandas(df) -> Dataset:
    """One block holding the DataFrame's columns (through pyarrow, as the
    JAX package reads it), put to the store now."""
    import pyarrow as pa

    return _input(_block.from_arrow(
        pa.Table.from_pandas(df, preserve_index=False)), "FromPandas")


def from_arrow(table) -> Dataset:
    """One block holding the Arrow table's columns (``block.from_arrow``),
    put to the store now."""
    return _input(_block.from_arrow(table), "FromArrow")


def read_parquet(paths, *, columns: Optional[List[str]] = None,
                 override_num_blocks: Optional[int] = None) -> Dataset:
    return _read("ReadParquet",
                 _ds.parquet_tasks(paths, _par(override_num_blocks), columns))


def read_csv(paths, *, override_num_blocks: Optional[int] = None) -> Dataset:
    return _read("ReadCSV", _ds.csv_tasks(paths, _par(override_num_blocks)))


def read_json(paths, *, override_num_blocks: Optional[int] = None) -> Dataset:
    return _read("ReadJSON", _ds.json_tasks(paths, _par(override_num_blocks)))


def read_text(paths, *, override_num_blocks: Optional[int] = None) -> Dataset:
    return _read("ReadText", _ds.text_tasks(paths, _par(override_num_blocks)))


def read_images(paths, *, size=None, mode: str = "RGB",
                include_paths: bool = False,
                override_num_blocks: Optional[int] = None) -> Dataset:
    return _read("ReadImages", _ds.image_tasks(
        paths, _par(override_num_blocks), size=size, mode=mode,
        include_paths=include_paths))


def from_huggingface(hf_dataset, *,
                     override_num_blocks: Optional[int] = None) -> Dataset:
    """Rows of a `datasets.Dataset`, one read task per slice of its Arrow
    table."""
    return _read("FromHuggingFace", _ds.huggingface_tasks(
        hf_dataset, _par(override_num_blocks)))


def read_binary_files(paths, *, include_paths: bool = False,
                      override_num_blocks: Optional[int] = None) -> Dataset:
    return _read("ReadBinary",
                 _ds.binary_tasks(paths, _par(override_num_blocks),
                                  include_paths))


def read_numpy(paths, *, override_num_blocks: Optional[int] = None) -> Dataset:
    return _read("ReadNumpy", _ds.numpy_tasks(paths, _par(override_num_blocks)))


def read_tfrecords(paths, *, raw_bytes: bool = False,
                   override_num_blocks: Optional[int] = None) -> Dataset:
    """Rows from tf.train.Example records (Ray's read_tfrecords), decoded
    without tensorflow."""
    return _read("ReadTFRecords", _ds.tfrecord_tasks(
        paths, _par(override_num_blocks), raw_bytes=raw_bytes))


def read_webdataset(paths, *,
                    override_num_blocks: Optional[int] = None) -> Dataset:
    """Samples from webdataset tar shards (Ray's read_webdataset)."""
    return _read("ReadWebDataset", _ds.webdataset_tasks(
        paths, _par(override_num_blocks)))


def read_sql(sql: str, connection_factory, *,
             fetch_size: int = 4096) -> Dataset:
    """Rows from any DB-API 2.0 query (Ray's read_sql)."""
    return _read("ReadSQL", _ds.sql_tasks(
        sql, connection_factory, fetch_size=fetch_size))


def read_avro(paths, *, override_num_blocks: Optional[int] = None) -> Dataset:
    """Avro Object Container Files through a pure-Python decoder (Ray's
    read_avro calls fastavro)."""
    return _read("ReadAvro", _ds.avro_tasks(paths, _par(override_num_blocks)))


def from_torch(torch_dataset, *,
               override_num_blocks: Optional[int] = None) -> Dataset:
    """Rows ({"item": sample}) from a torch Dataset (Ray's read_api.py
    from_torch); a map-style dataset is sharded by index."""
    return _read("FromTorch", _ds.torch_tasks(
        torch_dataset, _par(override_num_blocks)))


def from_tf(tf_dataset) -> Dataset:
    """Rows from a tf.data.Dataset, or anything with
    ``as_numpy_iterator``, drawn here (Ray's read_api.py from_tf draws
    eagerly too: a tf.data graph cannot cross processes); tensorflow is
    not imported."""
    rows = []
    for elem in tf_dataset.as_numpy_iterator():
        if isinstance(elem, dict):
            rows.append(dict(elem))
        elif isinstance(elem, tuple):
            rows.append({f"item_{i}": v for i, v in enumerate(elem)})
        else:
            rows.append({"item": elem})
    return from_items(rows)


def read_clickhouse(query: str, *, dsn: str = "http://localhost:8123",
                    partition_key: Optional[str] = None,
                    user: Optional[str] = None,
                    password: Optional[str] = None,
                    override_num_blocks: Optional[int] = None) -> Dataset:
    """Rows of a ClickHouse query over the server's HTTP interface
    (FORMAT JSONEachRow), fanned out by modulo(partition_key, N) when a
    numeric partition key is given (Ray's clickhouse datasource calls
    clickhouse-connect)."""
    return _read("ReadClickHouse", _ds.clickhouse_tasks(
        query, dsn, _par(override_num_blocks),
        partition_key=partition_key, user=user, password=password))


def _gated_reader(api_name: str, pip_pkg: str, sketch: str,
                  import_name: Optional[str] = None):
    """Cloud/warehouse datasources whose client wheels are in neither
    image (Ray ships them in _internal/datasource/).  Each raises the
    JAX package's ImportError naming the wheel rather than pretending.
    import_name is the module to probe when it differs from the pip name
    (cv2 vs opencv-python etc.)."""
    mod = import_name or pip_pkg.replace("-", "_")

    def reader(*args, **kwargs):
        try:
            __import__(mod)
        except ImportError as e:
            raise ImportError(
                f"{api_name} requires the `{pip_pkg}` package (not in the "
                f"TPU image).  Once installed: {sketch}") from e
        raise NotImplementedError(
            f"{api_name}: client wheel present but the TPU-image build "
            f"gates this path; read via an exported format "
            f"(read_parquet/read_sql) or file an issue")

    reader.__name__ = api_name
    reader.__qualname__ = api_name
    reader.__doc__ = (f"{api_name} (gated: needs `{pip_pkg}`). {sketch}")
    return reader


read_bigquery = _gated_reader(
    "read_bigquery", "google-cloud-bigquery",
    "runs a BQ Storage API read session, one stream per read task",
    import_name="google.cloud.bigquery")
read_lance = _gated_reader(
    "read_lance", "pylance",
    "reads dataset fragments, one per read task", import_name="lance")
read_hudi = _gated_reader(
    "read_hudi", "hudi",
    "reads file slices from the latest commit timeline")
read_databricks_tables = _gated_reader(
    "read_databricks_tables", "databricks-sql-connector",
    "pages results through the Databricks SQL statement API",
    import_name="databricks.sql")


def read_mongo(uri: str, database: str, collection: str, *,
               filter: Optional[dict] = None,
               projection: Optional[dict] = None,
               override_num_blocks: Optional[int] = None) -> Dataset:
    """Rows of a MongoDB collection, partitioned by `_id` ranges — one
    independent range cursor per read task, spoken over the raw OP_MSG
    wire protocol (data/mongo.py), no pymongo and no pyarrow.  The plan
    (two finds) runs in the caller's process, the reads in the tasks'."""
    from ray_tpu_torch.data.mongo import mongo_tasks

    return _read("ReadMongo",
                 mongo_tasks(uri, database, collection,
                             _par(override_num_blocks), filter=filter,
                             projection=projection))


def read_delta_sharing(url: str, *, limit: Optional[int] = None,
                       override_num_blocks: Optional[int] = None) -> Dataset:
    """Rows of a Delta Sharing table snapshot
    (``<profile-file>#share.schema.table``), spoken over the open REST
    protocol directly — presigned parquet files decode per read task
    through pyarrow (data/delta_sharing.py, no `delta-sharing` wheel)."""
    from ray_tpu_torch.data.delta_sharing import delta_sharing_tasks

    ds = _read("ReadDeltaSharing",
               delta_sharing_tasks(url, _par(override_num_blocks),
                                   limit=limit))
    # limitHint is advisory (servers MAY ignore it): enforce client-side
    return ds.limit(limit) if limit is not None else ds


def read_audio(paths, *,
               override_num_blocks: Optional[int] = None) -> Dataset:
    """Decoded audio per file: {amplitude float32[ch, samples],
    sample_rate, path}.  PCM/float WAV decodes natively (stdlib);
    other containers use `soundfile` when installed (data/audio.py)."""
    from ray_tpu_torch.data.audio import audio_tasks

    return _read("ReadAudio",
                 audio_tasks(paths, _par(override_num_blocks)))


def read_iceberg(table_dir: str, *, snapshot_id: Optional[int] = None,
                 columns: Optional[List[str]] = None,
                 override_num_blocks: Optional[int] = None) -> Dataset:
    """Rows of an Iceberg table's current (or named) snapshot, one read
    task per live parquet data file — native metadata-chain walk, no
    pyiceberg; the data files through pyarrow (data/lakehouse.py)."""
    from ray_tpu_torch.data.lakehouse import iceberg_tasks

    return _read("ReadIceberg", iceberg_tasks(
        table_dir, _par(override_num_blocks), snapshot_id=snapshot_id,
        columns=columns))


def read_videos(paths, *, override_num_blocks: Optional[int] = None
                ) -> Dataset:
    """One row per decoded frame ({"frame": HxWx3 uint8 RGB,
    "frame_index", "path"}); AVI/MJPEG (through PIL) and raw DIB decode
    natively, other containers fall back to cv2 when importable (Ray's
    video datasource calls opencv; data/video.py)."""
    from ray_tpu_torch.data.video import video_tasks

    return _read("ReadVideos", video_tasks(paths, _par(override_num_blocks)))


__all__ = [
    "Block",
    "BlockMetadata",
    "Chain",
    "Concatenator",
    "DataContext",
    "DataIterator",
    "Dataset",
    "GroupedData",
    "LabelEncoder",
    "MaterializedDataset",
    "MinMaxScaler",
    "OneHotEncoder",
    "Preprocessor",
    "SimpleImputer",
    "StandardScaler",
    "from_arrow",
    "from_huggingface",
    "from_items",
    "from_numpy",
    "from_pandas",
    "from_tf",
    "from_torch",
    "range",
    "read_audio",
    "read_avro",
    "read_binary_files",
    "read_clickhouse",
    "read_csv",
    "read_delta_sharing",
    "read_iceberg",
    "read_images",
    "read_json",
    "read_mongo",
    "read_numpy",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
    "read_videos",
    "read_webdataset",
    "service",
]
