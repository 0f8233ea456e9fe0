"""The port's TorchTrainer on the CPU, its exports, and the checkpoint
score repair.

One ``TorchTrainer.fit`` at 2 gloo workers runs a loop that records what
the tests read: the environment a torch program reads, the process
group's backend, ``prepare_model``'s DDP gradient against the full-batch
gradient, ``prepare_data_loader``'s loader, the dataset shard's type, and
the first loss of GPT-2 tiny over ``iter_torch_batches(device="cpu")``,
held to JAX's ``gpt2.loss_fn`` on the same parameters and rows.  The
workers are actors of the port's runtime, which a module fixture starts;
the loops cross to them pickled by value.  The trainer's ``callbacks`` and
the context's ``trial_info`` are held to the JAX package's.
"""

import dataclasses
import json
import os
import sys

import cloudpickle
import numpy as np
import pytest
import torch

from ray_tpu_torch import data, train
from ray_tpu_torch.train.config import RunConfig, ScalingConfig

cloudpickle.register_pickle_by_value(sys.modules[__name__])

WORKERS = 2
BATCH, SEQ = 2, 16
DDP_TOL = 1e-6  # f32 gradients of a 4x3 linear layer, two halves averaged
LOSS_TOL = 1e-5  # tests/test_torch_gpt2.py's f32 loss bound


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the worker processes
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def runtime(one_thread):
    import ray_tpu_torch as rt

    rt.init(num_cpus=4, min_workers=1, object_store_memory=1 << 27)
    try:
        yield rt
    finally:
        rt.shutdown()


def _gpt2_config():
    from ray_tpu_torch.models import gpt2

    return dataclasses.replace(gpt2.GPT2Config.tiny(), dtype="float32")


def _tokens():
    return np.random.default_rng(11).integers(
        0, 512, (4 * WORKERS * BATCH, SEQ + 1)).astype(np.int32)


def _ddp_data():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((8, 4)).astype(np.float32),
            rng.standard_normal((8, 3)).astype(np.float32))


def _torch_loop(config):
    """Every rank records its environment, the DDP and full-batch
    gradients, the prepared loader's options, its shard's type and its
    first GPT-2 loss into ``rank<r>.json`` under ``config["out"]``."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader, DistributedSampler

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step
    from ray_tpu_torch.train.torch import prepare_data_loader, prepare_model

    rank = dist.get_rank()
    rec = {k: os.environ.get(k) for k in
           ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
            "LOCAL_RANK")}
    rec["backend"] = dist.get_backend()

    # prepare_model: DDP's averaged gradient of each rank's half
    torch.manual_seed(0)
    local = torch.nn.Linear(4, 3)
    full = torch.nn.Linear(4, 3)
    full.load_state_dict(local.state_dict())
    model = prepare_model(local)
    rec["ddp"] = type(model).__name__
    x, y = (torch.from_numpy(a) for a in _ddp_data())
    half = slice(rank * 4, rank * 4 + 4)
    torch.nn.functional.mse_loss(model(x[half]), y[half]).backward()
    torch.nn.functional.mse_loss(full(x), y).backward()
    rec["ddp_grad_err"] = max(
        float((a.grad - b.grad).abs().max())
        for a, b in zip(model.module.parameters(), full.parameters()))

    # prepare_data_loader keeps the loader's options
    loader = DataLoader(list(range(10)), batch_size=3, shuffle=True,
                        drop_last=True, collate_fn=torch.tensor,
                        pin_memory=False, num_workers=0)
    prepared = prepare_data_loader(loader)
    rec["loader"] = {
        "sampler": type(prepared.sampler).__name__,
        "shuffle": isinstance(prepared.sampler, DistributedSampler)
        and prepared.sampler.shuffle,
        "batch_size": prepared.batch_size, "drop_last": prepared.drop_last,
        "collate_fn": prepared.collate_fn is torch.tensor,
        "num_workers": prepared.num_workers,
        "pin_memory": prepared.pin_memory,
        "indices": sorted(int(i) for b in prepared for i in b)}

    # the user's loop: the shard through iter_torch_batches into the step
    shard = train.get_dataset_shard("train")
    rec["shard"] = type(shard).__name__
    cfg = _gpt2_config()
    opt = step.default_optimizer(warmup_steps=1)
    state = step.create_train_state(
        gpt2, cfg, opt, torch.Generator().manual_seed(0), "cpu")
    run = step.make_train_step(gpt2, cfg, opt, attn_impl="flash")
    losses, rows = [], []
    for batch in shard.iter_torch_batches(batch_size=BATCH, drop_last=True,
                                          dtypes=torch.int64, device="cpu"):
        rows.append(batch["tokens"].tolist())
        state, m = run(state, batch["tokens"])
        losses.append(float(m["loss"]))
    rec.update(losses=losses, rows=rows)
    with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    train.report({"rank": rank, "steps": len(losses)})


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_trainer")
    rows = [{"tokens": r} for r in _tokens()]
    trainer = train.TorchTrainer(
        _torch_loop, train_loop_config={"out": str(out)},
        torch_config=train.TorchConfig(backend="gloo", timeout_s=120),
        scaling_config=ScalingConfig(num_workers=WORKERS, use_gpu=False),
        run_config=RunConfig(name="torch", storage_path=str(out)),
        datasets={"train": data.from_items(rows, override_num_blocks=4)})
    result = trainer.fit()
    assert result.error is None, result.error
    recs = []
    for r in range(WORKERS):
        with open(out / f"rank{r}.json") as f:
            recs.append(json.load(f))
    return result, recs


def test_torch_trainer_sets_the_torch_environment(fitted):
    result, recs = fitted
    assert result.metrics == {"rank": 0, "steps": 4}
    from ray_tpu.train.torch import _default_master_addr

    ports = {rec["MASTER_PORT"] for rec in recs}
    assert len(ports) == 1 and int(ports.pop()) > 0
    for r, rec in enumerate(recs):
        # TorchConfig's default address is the JAX package's
        assert rec["MASTER_ADDR"] == _default_master_addr()
        assert (rec["RANK"], rec["LOCAL_RANK"], rec["WORLD_SIZE"]) == (
            str(r), str(r), str(WORKERS))
        assert rec["backend"] == "gloo"


def _env_loop(config):
    """Every rank writes the group's address and its rank, as a torch
    program reads them, into ``rank<r>.json``."""
    import torch.distributed as dist

    rec = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT")}
    rec["rank"] = dist.get_rank()
    with open(os.path.join(config["out"], f"rank{rec['rank']}.json"),
              "w") as f:
        json.dump(rec, f)


def test_torch_config_address_and_port_reach_every_rank(tmp_path):
    """``TorchConfig(master_addr=..., master_port=...)``, the JAX
    package's fields, is where the ranks' group forms."""
    from ray_tpu_torch.train.worker_group import _free_port

    port = _free_port()
    result = train.TorchTrainer(
        _env_loop, train_loop_config={"out": str(tmp_path)},
        torch_config=train.TorchConfig(backend="gloo", timeout_s=120,
                                       master_addr="127.0.0.1",
                                       master_port=port),
        scaling_config=ScalingConfig(num_workers=WORKERS, use_gpu=False),
        run_config=RunConfig(name="env", storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    for r in range(WORKERS):
        with open(tmp_path / f"rank{r}.json") as f:
            assert json.load(f) == {"MASTER_ADDR": "127.0.0.1",
                                    "MASTER_PORT": str(port), "rank": r}


def test_prepare_model_ddp_gradient_is_the_full_batch_gradient(fitted):
    _, recs = fitted
    for rec in recs:
        assert rec["ddp"] == "DistributedDataParallel"
        assert rec["ddp_grad_err"] < DDP_TOL


def test_prepare_data_loader_keeps_the_loaders_options(fitted):
    _, recs = fitted
    for rec in recs:
        assert rec["loader"] == {
            "sampler": "DistributedSampler", "shuffle": True,
            "batch_size": 3, "drop_last": True, "collate_fn": True,
            "num_workers": 0, "pin_memory": False,
            "indices": rec["loader"]["indices"]}
        assert len(rec["loader"]["indices"]) == 3
    # the two ranks' samples are disjoint halves of the dataset
    assert not set(recs[0]["loader"]["indices"]) & set(
        recs[1]["loader"]["indices"])


def test_get_dataset_shard_is_a_data_iterator(fitted):
    """Each rank reads the blocks dealt to it, in order."""
    _, recs = fitted
    tokens = _tokens().tolist()
    per_block = len(tokens) // 4
    for r, rec in enumerate(recs):
        assert rec["shard"] == "DataIterator"
        want = [row for b in range(r, 4, WORKERS)
                for row in tokens[b * per_block:(b + 1) * per_block]]
        assert [row for batch in rec["rows"] for row in batch] == want


def test_gpt2_loop_first_loss_matches_jax(fitted):
    """Each rank's first loss against JAX's ``gpt2.loss_fn`` on the port's
    initial parameters and the rank's first batch."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.step import tree_map

    _, recs = fitted
    params = tree_map(lambda t: jnp.asarray(t.numpy()), gpt2.init(
        _gpt2_config(), torch.Generator().manual_seed(0), "cpu"))
    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype="float32")
    loss = jax.jit(lambda p, t: jgpt2.loss_fn(p, t, jcfg, attn_impl="xla"))
    for rec in recs:
        want = float(loss(params, jnp.asarray(rec["rows"][0], jnp.int32)))
        assert abs(rec["losses"][0] - want) < LOSS_TOL
        assert np.isfinite(rec["losses"]).all()


# ---------------------------------------------------------------------------
# a preprocessing pipeline through streaming_split into the ranks

PIPELINE_ROWS, PIPELINE_BLOCKS, PIPELINE_SEED = 16, 4, 37


def _make_rows(batch):
    """Each row's SEQ + 1 token ids from ``default_rng(37 + id)``: the
    stand-in for tokenization."""
    return {"tokens": np.stack([
        np.random.default_rng(37 + int(i)).integers(0, 512, SEQ + 1)
        for i in batch["id"]])}


def _pipeline(data):
    return data.range(PIPELINE_ROWS, override_num_blocks=PIPELINE_BLOCKS) \
        .map_batches(_make_rows).random_shuffle(seed=PIPELINE_SEED)


def _pipeline_loop(config):
    """Every rank's rows and GPT-2 losses over its shard into
    ``rank<r>.json``."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step

    cfg = _gpt2_config()
    opt = step.default_optimizer(warmup_steps=1)
    state = step.create_train_state(
        gpt2, cfg, opt, torch.Generator().manual_seed(0), "cpu")
    run = step.make_train_step(gpt2, cfg, opt, attn_impl="flash")
    rows, losses = [], []
    for batch in train.get_dataset_shard("train").iter_torch_batches(
            batch_size=BATCH, drop_last=True, device="cpu"):
        rows.append(batch["tokens"].tolist())
        state, m = run(state, batch["tokens"])
        losses.append(float(m["loss"]))
    with open(os.path.join(config["out"],
                           f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump({"rows": rows, "losses": losses}, f)
    train.report({"steps": len(losses)})


def test_a_pipeline_feeds_the_ranks_as_jaxs_streaming_split_deals_it(
        tmp_path, ray_cluster):
    import ray_tpu.data as jdata

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step

    result = train.TorchTrainer(
        _pipeline_loop, train_loop_config={"out": str(tmp_path)},
        torch_config=train.TorchConfig(backend="gloo", timeout_s=120),
        scaling_config=ScalingConfig(num_workers=WORKERS, use_gpu=False),
        run_config=RunConfig(name="pipeline", storage_path=str(tmp_path)),
        datasets={"train": _pipeline(data)}).fit()
    assert result.error is None, result.error
    recs = []
    for r in range(WORKERS):
        with open(tmp_path / f"rank{r}.json") as f:
            recs.append(json.load(f))
    shards = _pipeline(jdata).streaming_split(WORKERS)
    cfg = _gpt2_config()
    opt = step.default_optimizer(warmup_steps=1)
    run = step.make_train_step(gpt2, cfg, opt, attn_impl="flash")
    for rec, shard in zip(recs, shards):
        want = [b["tokens"].tolist() for b in shard.iter_batches(
            batch_size=BATCH, drop_last=True)]
        assert rec["rows"] == want and want
        state = step.create_train_state(
            gpt2, cfg, opt, torch.Generator().manual_seed(0), "cpu")
        own = []
        for rows in rec["rows"]:
            state, m = run(state, torch.tensor(rows))
            own.append(float(m["loss"]))
        assert rec["losses"] == own
    assert sum(len(rec["rows"]) for rec in recs) * BATCH <= PIPELINE_ROWS


def _fail_once_loop(config):
    """Reads its shard; the first attempt then fails."""
    rows = sum(len(b["id"]) for b in
               train.get_dataset_shard("train").iter_batches(batch_size=4))
    marker = os.path.join(config["out"], "failed_once")
    if not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("first attempt fails")
    train.report({"rows": rows})


def test_each_attempt_splits_anew_and_ends_its_coordinator(tmp_path):
    """The controller's second attempt re-splits the dataset through a
    fresh coordinator and reads every row again; when an attempt ends its
    coordinator is killed."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.exceptions import ActorDiedError
    from ray_tpu_torch.train.config import FailureConfig

    trainer = train.TorchTrainer(
        _fail_once_loop, train_loop_config={"out": str(tmp_path)},
        torch_config=train.TorchConfig(backend="gloo", timeout_s=120),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="attempts", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
        datasets={"train": data.range(24, override_num_blocks=3)})
    splits = []
    factory = trainer._dataset_factory

    def recording(n):
        shards = factory(n)
        splits.append(shards)
        return shards

    trainer._dataset_factory = recording
    result = trainer.fit()
    assert result.error is None, result.error
    assert result.metrics == {"rows": 24}
    coords = [shards[0]["train"]._bundles._coord for shards in splits]
    assert len(coords) == 2 and coords[0].actor_id != coords[1].actor_id
    for coord in coords:
        with pytest.raises(ActorDiedError):
            rt.get(coord.get_next.remote(0), timeout=60)


def test_torch_trainer_on_the_gpu_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.TorchTrainer(_torch_loop, scaling_config=ScalingConfig())


# ---------------------------------------------------------------------------
# callbacks and trial_info, against the JAX package


def _trial_loop(config):
    from ray_tpu_torch import train as port_train

    ctx = port_train.get_context()
    for i in range(3):
        port_train.report({"i": i, "name": ctx.get_trial_name(),
                           "id": ctx.get_trial_id()})


def _jax_trial_loop(config):
    from ray_tpu import train as jax_train

    ctx = jax_train.get_context()
    for i in range(3):
        jax_train.report({"i": i, "name": ctx.get_trial_name(),
                          "id": ctx.get_trial_id()})


def test_callbacks_and_trial_info_match_jax(tmp_path, ray_cluster):
    """A controller given ``trial_info`` and a ``callbacks`` list: the
    workers read the trial's name and id, and each callback sees every
    committed report's index and metrics, in order, as the JAX
    package's does; without ``trial_info`` the name is the
    experiment's."""
    import ray_tpu.train as jax_train
    from ray_tpu.train.controller import TrainController as JaxController
    from ray_tpu_torch.train.controller import TrainController

    info = {"name": "trial_00003", "id": "abc123"}

    def run(controller_cls, scaling, run_config_cls, loop, trial_info,
            name):
        seen = []
        result = controller_cls(
            loop, {}, scaling, run_config_cls(
                name=name, storage_path=str(tmp_path / name)),
            trial_info=trial_info,
            callbacks=[lambda i, m, c: seen.append((i, m, c))]).run()
        assert result.error is None, result.error
        return [(i, m, c) for i, m, c in seen], result.metrics

    got, want = [], []
    for trial_info in (info, None):
        got.append(run(TrainController, ScalingConfig(
            num_workers=2, use_gpu=False), RunConfig, _trial_loop,
            trial_info, "port"))
        want.append(run(JaxController, jax_train.ScalingConfig(
            num_workers=2), jax_train.RunConfig, _jax_trial_loop,
            trial_info, "jax"))
    assert got[0] == want[0]
    assert got[0][0] == [(i, {"i": i, "name": "trial_00003",
                              "id": "abc123"}, None) for i in range(3)]
    # without trial_info: the experiment's name (each package's own)
    for (seen, _), name in ((got[1], "port"), (want[1], "jax")):
        assert seen == [(i, {"i": i, "name": name, "id": ""}, None)
                        for i in range(3)]


def test_trainers_pass_callbacks_to_the_controller(tmp_path):
    seen = []
    result = train.TorchTrainer(
        _trial_loop, train_loop_config={},
        torch_config=train.TorchConfig(backend="gloo", timeout_s=120),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="cb", storage_path=str(tmp_path)),
        callbacks=[lambda i, m, c: seen.append((i, m["i"], c))]).fit()
    assert result.error is None, result.error
    assert seen == [(0, 0, None), (1, 1, None), (2, 2, None)]


# ---------------------------------------------------------------------------
# the exports

# the JAX package's names the port leaves out, and why
TRAIN_LEFT_OUT = {
    "JaxTrainer": "DataParallelTrainer is its counterpart",
}
LLM_LEFT_OUT = {}


@pytest.mark.parametrize("package,left_out", [("train", TRAIN_LEFT_OUT),
                                              ("llm", LLM_LEFT_OUT)])
def test_exports_match_the_jax_package(package, left_out):
    import importlib

    jax_names = set(importlib.import_module(f"ray_tpu.{package}").__all__)
    port = importlib.import_module(f"ray_tpu_torch.{package}")
    assert set(left_out) <= jax_names
    assert jax_names - set(left_out) <= set(port.__all__)
    assert not set(left_out) & set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None


# ---------------------------------------------------------------------------
# the checkpoint manager's score


def test_an_unscored_checkpoint_ranks_worst_under_min(tmp_path):
    """num_to_keep 2, order "min", losses 1.0, missing, 5.0: the port keeps
    the best (1.0) and the latest (5.0); the JAX package ranks the
    unscored checkpoint best under "min" and deletes the best one."""
    from ray_tpu.train.checkpoint import CheckpointManager as JaxManager
    from ray_tpu.train.config import CheckpointConfig as JaxConfig
    from ray_tpu_torch.train.checkpoint import CheckpointManager
    from ray_tpu_torch.train.config import CheckpointConfig

    def kept(manager_cls, config_cls, root):
        mgr = manager_cls(str(root), config_cls(
            num_to_keep=2, checkpoint_score_attribute="loss",
            checkpoint_score_order="min"))
        for i, loss in enumerate([1.0, None, 5.0]):
            path = root / f"c{i}"
            path.mkdir(parents=True)
            mgr.register_checkpoint(
                str(path), {} if loss is None else {"loss": loss}, i)
        return [m.get("loss") for _, m in mgr.best_checkpoints()]

    assert kept(CheckpointManager, CheckpointConfig,
                tmp_path / "port") == [1.0, 5.0]
    assert kept(JaxManager, JaxConfig, tmp_path / "jax") == [None, 5.0]
