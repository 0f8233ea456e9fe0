"""Gradient-boosted-tree trainers: XGBoost and LightGBM on the worker group.

Counterpart of ``ray_tpu/train/gbdt.py``, that is, of Ray's
python/ray/train/xgboost/ and lightgbm/ (``XGBoostTrainer``,
``LightGBMTrainer``): data-parallel GBDT where each rank trains on its
dataset shard and the library's own collective (xgboost's tracker,
lightgbm's socket machines list) does the histogram allreduce.  The
trainers are the port's ``DataParallelTrainer`` where the JAX package's
subclass ``JaxTrainer``; with no ``scaling_config`` the worker runs on the
CPU, as the JAX package's does, and checkpoints go through
``train/checkpoint.py``.

Neither library is installed where the port runs, so construction is
import-gated with a clear error; the shard routing and the train-loop
assembly are plain Python and unit-tested with an injected fake module
(``tests/test_torch_ecosystem.py``).  Scope: single-worker training only.
The distributed mode needs the library's own tracker process, which
cannot be stood up or tested without the wheel, so ``num_workers > 1`` is
rejected at construction instead of silently training disconnected
per-shard models.
"""

from __future__ import annotations

from typing import Callable, Optional

from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import DataParallelTrainer


def _require(module_name: str, trainer_name: str):
    import importlib

    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            f"{trainer_name} requires the `{module_name}` package, which "
            f"is not in this image; `pip install {module_name}` on the "
            f"cluster (runtime_env={{'pip': ['{module_name}']}} works once "
            f"a wheel mirror is configured — see RTPU_PIP_ARGS)") from e


def _shard_to_xy(ctx, label: str):
    """This rank's dataset shard as (X, y) float32 matrices."""
    import numpy as np

    shard = ctx.get_dataset_shard("train")
    rows = list(shard.iter_rows()) if hasattr(shard, "iter_rows") \
        else list(shard)
    X = np.asarray([[v for k, v in sorted(r.items()) if k != label]
                    for r in rows], dtype=np.float32)
    y = np.asarray([r[label] for r in rows], dtype=np.float32)
    return X, y


def _xgboost_train_loop(config: dict):
    """Per-rank loop: build DMatrix from this rank's shard, train under the
    library's collective communicator, report metrics + rank-0 model."""
    import ray_tpu_torch.train as train

    xgb = _require("xgboost", "XGBoostTrainer")
    ctx = train.get_context()
    X, y = _shard_to_xy(ctx, config["label_column"])
    dtrain = xgb.DMatrix(X, label=y)
    evals_result: dict = {}
    with xgb.collective.CommunicatorContext(**config.get("comm", {})):
        # comm stays empty in the supported single-worker mode; the
        # context still standardizes the library's logging/abort paths
        bst = xgb.train(config.get("params", {}), dtrain,
                        num_boost_round=config.get("num_boost_round", 10),
                        evals=[(dtrain, "train")],
                        evals_result=evals_result)
    metrics = {k: v[-1] for k, v in evals_result.get("train", {}).items()}
    ckpt = None
    if ctx.get_world_rank() == 0:
        import os
        import tempfile

        from ray_tpu_torch.train.checkpoint import Checkpoint

        d = tempfile.mkdtemp(prefix="xgb_ckpt_")
        bst.save_model(os.path.join(d, "model.json"))
        ckpt = Checkpoint.from_directory(d)
    train.report(metrics, checkpoint=ckpt)


def _lightgbm_train_loop(config: dict):
    import ray_tpu_torch.train as train

    lgb = _require("lightgbm", "LightGBMTrainer")
    ctx = train.get_context()
    X, y = _shard_to_xy(ctx, config["label_column"])
    params = dict(config.get("params", {}))
    # distributed mode: lightgbm wants every rank's host:port
    params.update(config.get("network_params", {}))
    ds = lgb.Dataset(X, label=y)
    bst = lgb.train(params, ds,
                    num_boost_round=config.get("num_boost_round", 10))
    ckpt = None
    if ctx.get_world_rank() == 0:
        import os
        import tempfile

        from ray_tpu_torch.train.checkpoint import Checkpoint

        d = tempfile.mkdtemp(prefix="lgb_ckpt_")
        bst.save_model(os.path.join(d, "model.txt"))
        ckpt = Checkpoint.from_directory(d)
    train.report({"num_trees": bst.num_trees()}, checkpoint=ckpt)


class _GBDTTrainer(DataParallelTrainer):
    _LOOP: Callable = None  # type: ignore[assignment]
    _MODULE = ""
    _NAME = ""

    def __init__(self, *, params: Optional[dict] = None,
                 label_column: str = "label",
                 num_boost_round: int = 10,
                 datasets: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None):
        _require(self._MODULE, self._NAME)  # fail fast at construction
        if not datasets or "train" not in datasets:
            raise ValueError(f"{self._NAME} needs datasets={{'train': ...}}")
        if scaling_config is not None and \
                getattr(scaling_config, "num_workers", 1) > 1:
            raise ValueError(
                f"{self._NAME} supports num_workers=1 only: distributed "
                f"GBDT needs {self._MODULE}'s own tracker, which this "
                f"image cannot run or test (see module docstring)")
        super().__init__(
            type(self)._LOOP,
            train_loop_config={"params": params or {},
                               "label_column": label_column,
                               "num_boost_round": num_boost_round},
            scaling_config=scaling_config or ScalingConfig(use_gpu=False),
            run_config=run_config,
            datasets=datasets)


class XGBoostTrainer(_GBDTTrainer):
    """Ray's python/ray/train/xgboost/xgboost_trainer.py."""

    _LOOP = staticmethod(_xgboost_train_loop)
    _MODULE = "xgboost"
    _NAME = "XGBoostTrainer"


class LightGBMTrainer(_GBDTTrainer):
    """Ray's python/ray/train/lightgbm/lightgbm_trainer.py."""

    _LOOP = staticmethod(_lightgbm_train_loop)
    _MODULE = "lightgbm"
    _NAME = "LightGBMTrainer"
