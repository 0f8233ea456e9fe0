"""Data: lazy, streaming, distributed datasets over numpy blocks.

Counterpart of ``ray_tpu.data`` (Ray Data, python/ray/data/) on the
port's runtime: the constructors build a lazy logical plan, transforms
append ops, and consumption lowers it to physical operators run by a
pull-based streaming executor on the runtime's tasks and actors
(``dataset.py``, ``executor.py``).  Blocks are ``{column: ndarray}``
(``block.py``), where the JAX package's are pyarrow tables.
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


def from_numpy(arr, column: str = "item") -> Dataset:
    """One block holding ``arr`` as one column, its rows along axis 0, put
    to the store now (an initialised runtime is needed)."""
    import numpy as np

    import ray_tpu_torch as rt

    block = _block.from_batch({column: np.asarray(arr)})
    bundles = [(rt.put(block), BlockMetadata.of(block))]
    return Dataset(_L.LogicalPlan([_L.InputData(name="FromNumpy",
                                                bundles=bundles)]))


# The JAX package's names that wait for the data package's sources (a
# later slice): from_arrow, from_huggingface, from_pandas, from_tf,
# from_torch, read_audio, read_avro, read_binary_files, read_clickhouse,
# read_csv, read_delta_sharing, read_iceberg, read_images, read_json,
# read_mongo, read_numpy, read_parquet, read_sql, read_text,
# read_tfrecords, read_videos, read_webdataset, service.
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
    "from_items",
    "from_numpy",
    "range",
]
