"""The port's train package on the CPU: configs, the worker-side context and
``report``, checkpoints through ``torch.distributed.checkpoint`` and their
top-K retention, the controller's report barrier and its restart after a
worker raises, and the Llama-3 8B recipe's dry run across two gloo
worker processes with a restore at world size 1.

The trainers' workers are actors of the port's runtime, which a module
fixture starts; their train functions are this module's own, pickled by
value, and they run with one intra-op thread each.
"""

import os
import sys

import cloudpickle
import numpy as np
import pytest
import torch

from ray_tpu_torch import train
from ray_tpu_torch.train import context as train_context
from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.controller import TrainController

# the train functions cross to the worker actors, which cannot import
# this module
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module", autouse=True)
def runtime():
    """The port's runtime the trainers need, with a CPU for each of the
    widest trainer's two gloo ranks and room for the next attempt's."""
    import ray_tpu_torch as rt

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the worker processes
        rt.init(num_cpus=4, min_workers=1, object_store_memory=1 << 27)
        try:
            yield rt
        finally:
            rt.shutdown()


@pytest.fixture
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


# ---------------------------------------------------------------------------
# configs and the context


def test_config_validation_and_devices():
    with pytest.raises(ValueError, match="num_workers"):
        ScalingConfig(num_workers=0)
    with pytest.raises(ValueError, match="min_workers"):
        ScalingConfig(num_workers=2, min_workers=3)
    with pytest.raises(ValueError, match="checkpoint_score_order"):
        CheckpointConfig(checkpoint_score_order="best")
    gpu, cpu = ScalingConfig(num_workers=2), ScalingConfig(use_gpu=False)
    # under its grant each worker actor sees its own card alone: cuda:0
    assert (gpu.device, gpu.backend) == ("cuda:0", "nccl")
    assert (cpu.device, cpu.backend) == ("cpu", "gloo")
    assert gpu.bundle() == {"CPU": 1, "GPU": 1}
    assert cpu.bundle() == {"CPU": 1}
    assert ScalingConfig(resources_per_worker={"CPU": 2, "GPU": 2}
                         ).bundle() == {"CPU": 2, "GPU": 2}
    assert (gpu.placement_strategy, gpu.min_workers) == ("STRICT_PACK", None)
    run = RunConfig()
    assert run.failure_config.max_failures == 0
    assert run.checkpoint_config.num_to_keep is None


def _context(tmp_path, **kw):
    return train_context.TrainContext(
        rank=1, local_rank=1, world_size=2, experiment_name="exp",
        experiment_dir=str(tmp_path / "exp"), **kw)


def test_context_and_report(tmp_path):
    with pytest.raises(RuntimeError, match="outside a train function"):
        train.get_context()
    ctx = _context(tmp_path, start_report_index=5,
                   dataset_shards={"train": [1, 3]},
                   restore_checkpoint_path=str(tmp_path))
    train_context._set_context(ctx)
    try:
        assert train.get_context() is ctx
        assert (ctx.get_world_rank(), ctx.get_local_rank(),
                ctx.get_world_size(), ctx.get_device()) == (1, 1, 2, "cpu")
        assert train.get_dataset_shard("train") == [1, 3]
        with pytest.raises(KeyError):
            train.get_dataset_shard("eval")
        assert train.get_checkpoint().path == str(tmp_path)
        # a directory inside the experiment is committed where it lies
        inside = tmp_path / "exp" / "ckpt-000001"
        inside.mkdir(parents=True)
        train.report({"loss": 1.0}, checkpoint=Checkpoint(str(inside)))
        # any other is copied in under the report's index
        outside = tmp_path / "elsewhere"
        outside.mkdir()
        (outside / "w.bin").write_bytes(b"abc")
        train.report({"loss": 0.5}, checkpoint=Checkpoint(str(outside)))
        train.report({"loss": 0.25})
        got = [ctx.outbox.get_nowait() for _ in range(3)]
        assert [r["index"] for r in got] == [5, 6, 7]
        assert [r["checkpoint_dir"] for r in got] == [
            "ckpt-000001", "checkpoint_000006", None]
        assert (tmp_path / "exp" / "checkpoint_000006" / "w.bin"
                ).read_bytes() == b"abc"
        assert all(r["rank"] == 1 for r in got)
        ctx.stop_event.set()
        with pytest.raises(train_context._StopTraining):
            train.report({"loss": 0.0})
    finally:
        train_context._set_context(None)


# ---------------------------------------------------------------------------
# checkpoints


def test_checkpoint_manager_keeps_top_k(tmp_path):
    cfg = CheckpointConfig(num_to_keep=2, checkpoint_score_attribute="loss",
                           checkpoint_score_order="min")
    mgr = CheckpointManager(str(tmp_path), cfg)
    paths = []
    for i, loss in enumerate([3.0, 1.0, 2.0, 4.0]):
        p = tmp_path / f"c{i}"
        p.mkdir()
        paths.append(str(p))
        mgr.register_checkpoint(str(p), {"loss": loss}, i)
    # the best (loss 1.0) and the latest (needed to resume) stay
    kept = [c.path for c, _ in mgr.best_checkpoints()]
    assert kept == [paths[1], paths[3]]
    assert [os.path.exists(p) for p in paths] == [False, True, False, True]
    assert mgr.latest_checkpoint.path == paths[3]
    again = CheckpointManager(str(tmp_path), cfg)  # from the manifest
    assert [c.path for c, _ in again.best_checkpoints()] == kept
    assert again.latest_index == 3


def test_save_and_load_pytree(tmp_path):
    """A tree of tensors and numbers, whole (no process group): loaded
    onto new tensors, and in place into a target."""
    gen = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn(4, 6, generator=gen),
                       "b": torch.randn(6, generator=gen)},
            "opt_state": {"count": 3}, "step": 3}
    nbytes = save_pytree(str(tmp_path), tree)
    assert nbytes == (24 + 6) * 4 + 2 * 8
    whole = load_pytree(str(tmp_path), device="cpu")
    assert torch.equal(whole["params"]["w"], tree["params"]["w"])
    assert int(whole["step"]) == 3 and int(whole["opt_state"]["count"]) == 3
    target = {"params": {"w": torch.zeros(4, 6), "b": torch.zeros(6)},
              "opt_state": {"count": 0}, "step": 0}
    w = target["params"]["w"]
    out = load_pytree(str(tmp_path), target)
    assert out["params"]["w"] is w and torch.equal(w, tree["params"]["w"])
    assert out["step"] == 3 and isinstance(out["step"], int)
    if not torch.cuda.is_available():  # whole loads go to CUDA by default
        with pytest.raises(RuntimeError, match="CUDA"):
            load_pytree(str(tmp_path))


# ---------------------------------------------------------------------------
# the controller


class _ScriptedGroup:
    """A worker group whose polls are scripted; records how many reports
    the controller had processed before each poll."""

    num_workers = 2

    def __init__(self, script, seen):
        self._script, self._seen, self.before = iter(script), seen, []

    def poll(self):
        self.before.append(len(self._seen))
        return next(self._script)

    def stop(self):
        raise AssertionError("no rank failed")


def test_report_barrier_commits_once_every_rank_reported(tmp_path):
    ctl = TrainController(lambda: None, None, ScalingConfig(use_gpu=False),
                          RunConfig(name="barrier",
                                    storage_path=str(tmp_path)))
    seen = []
    process = ctl._process_report
    ctl._process_report = lambda reps: (seen.append(
        sorted(r["rank"] for r in reps)), process(reps))

    def rep(rank, index, ckpt=None):
        return {"index": index, "metrics": {"i": index, "rank": rank},
                "checkpoint_dir": ckpt, "rank": rank}

    def poll(r0, r1, done=False):
        return [{"reports": r0, "done": done, "error": None},
                {"reports": r1, "done": done, "error": None}]

    script = [poll([rep(0, 0, "c0"), rep(0, 1)], []),
              poll([], [rep(1, 0, "c0")]),
              poll([], []),
              poll([], [rep(1, 1)], done=True)]
    group = _ScriptedGroup(script, seen)
    assert ctl._poll_until_done(group) is None
    # index 0 waited for rank 1's report in the second poll, index 1 for
    # the fourth
    assert group.before == [0, 0, 1, 1]
    assert seen == [[0, 1], [0, 1]]
    result = ctl._result(None)
    assert result.metrics == {"i": 1, "rank": 0}
    assert result.checkpoint.path == os.path.join(ctl.experiment_dir, "c0")


def _flaky_loop(config):
    """Reports once with a checkpoint; on the first attempt rank 1 then
    raises, on the restart (which sees the committed checkpoint) both
    ranks report twice more."""
    ctx = train.get_context()
    restored = train.get_checkpoint()
    d = os.path.join(ctx.experiment_dir, f"ckpt-{ctx._report_index}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"rank{ctx.get_world_rank()}"), "w") as f:
        f.write(restored.path if restored else "")
    torch.distributed.barrier()
    train.report({"phase": "first", "restored": restored is not None},
                 checkpoint=train.Checkpoint(d))
    if restored is None and ctx.get_world_rank() == 1:
        raise ValueError("worker 1 fails once")
    for i in range(2):
        train.report({"phase": "again", "i": i,
                      "restored": restored is not None})


def test_controller_restarts_after_a_worker_raises(tmp_path, one_thread):
    result = train.DataParallelTrainer(
        _flaky_loop,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="flaky", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert result.error is None
    assert result.metrics == {"phase": "again", "i": 1, "restored": True}
    # attempt 1 committed index 0; attempt 2 reported indices 1, 2, 3
    assert result.checkpoint.path == os.path.join(result.path, "ckpt-1")
    with open(os.path.join(result.checkpoint.path, "rank1")) as f:
        assert f.read() == os.path.join(result.path, "ckpt-0")


def _failing_loop():
    raise RuntimeError("always")


def test_controller_gives_up_past_max_failures(tmp_path, one_thread):
    result = train.DataParallelTrainer(
        _failing_loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="fail", storage_path=str(tmp_path)),
    ).fit()
    assert isinstance(result.error, train.TrainingFailedError)
    assert "always" in str(result.error)
    assert result.metrics is None and result.checkpoint is None


def _shard_loop():
    train.report({"shard": train.get_dataset_shard("train")})


def test_datasets_are_sharded_per_rank(tmp_path, one_thread):
    trainer = train.DataParallelTrainer(
        _shard_loop, datasets={"train": list(range(5))},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="shards", storage_path=str(tmp_path)))
    assert trainer._dataset_factory(2) == [{"train": [0, 2, 4]},
                                           {"train": [1, 3]}]
    assert trainer.fit().metrics == {"shard": [0, 2, 4]}


# ---------------------------------------------------------------------------
# the Llama-3 8B recipe


def test_llama3_8b_recipe_dry_run(tmp_path, one_thread):
    """The recipe end to end at dry scale across 2 gloo workers
    (DataParallelTrainer -> controller -> worker actors -> fsdp x tp
    mesh, here tp 2 -> sharded step -> torch.distributed.checkpoint), then
    a restore at world size 1: the counterpart of ``tests/test_train.py``'s
    ``test_llama3_8b_recipe_dry_run``."""
    import jax

    from ray_tpu.models import llama as jllama
    from ray_tpu_torch.train.llama3 import train_llama3_8b
    from ray_tpu_torch.train.step import tree_leaves

    result = train_llama3_8b(num_workers=2, dry_run=True, steps=2,
                             ckpt_every=2, seq_len=64, device="cpu",
                             storage_path=str(tmp_path))
    assert result.error is None
    assert result.metrics["step"] == 2
    assert 0 < result.metrics["loss"] < 20
    # steady-state numbers come from the steps past the first that ended
    # before the report (none here, as in the JAX recipe)
    assert result.metrics["tokens_per_sec"] == 0.0
    assert result.metrics["flops_source"] == "analytic"
    assert result.checkpoint is not None

    with result.checkpoint.as_directory() as d:
        restored = load_pytree(d, device="cpu")
    shapes = jax.eval_shape(lambda: jllama.init(
        jllama.LlamaConfig.llama3_8b_dry(), jax.random.PRNGKey(0)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    n_params = sum(t.numel() for t in tree_leaves(restored["params"]))
    assert n_params == want == result.metrics["n_params"]
    assert n_params > 1_000_000
    assert int(restored["step"]) == 2
    assert int(restored["opt_state"]["count"]) == 2
    for p, m in zip(tree_leaves(restored["params"]),
                    tree_leaves(restored["opt_state"]["mu"])):
        assert p.shape == m.shape and torch.isfinite(p).all()
