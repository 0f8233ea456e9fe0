"""DataParallelTrainer: the user-facing data-parallel trainer.

Counterpart of ``ray_tpu/train/trainer.py`` (``JaxTrainer``, whose alias
is ``DataParallelTrainer``): the train function runs once per worker
process, builds its device mesh over the group (``parallel.mesh.
create_mesh``) and expresses dp / fsdp / tp / sp through the sharded step
(``train.step``).
"""

from __future__ import annotations

from typing import Callable, Optional

from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import Result, TrainController


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[dict] = None,
    ):
        self._train_fn = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self._scaling_config = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        self._datasets = datasets or {}
        self._group_options: dict = {}

    def _dataset_factory(self, num_shards: int) -> list:
        """Split each dataset into per-rank shards.

        Datasets exposing ``streaming_split`` split natively; plain
        lists/iterables are sharded round-robin.
        """
        per_rank: list[dict] = [{} for _ in range(num_shards)]
        for name, ds in self._datasets.items():
            if hasattr(ds, "streaming_split"):
                splits = ds.streaming_split(num_shards)
            else:
                items = list(ds)
                splits = [items[r::num_shards] for r in range(num_shards)]
            for r in range(num_shards):
                per_rank[r][name] = splits[r]
        return per_rank

    def fit(self) -> Result:
        factory = self._dataset_factory if self._datasets else None
        controller = TrainController(
            self._train_fn,
            self._train_loop_config,
            self._scaling_config,
            self._run_config,
            dataset_factory=factory,
            group_options=self._group_options,
        )
        return controller.run()
