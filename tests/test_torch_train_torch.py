"""The port's TorchTrainer on the CPU, its exports, and the checkpoint
score repair.

One ``TorchTrainer.fit`` at 2 gloo workers runs a loop that records what
the tests read: the environment a torch program reads, the process
group's backend, ``prepare_model``'s DDP gradient against the full-batch
gradient, ``prepare_data_loader``'s loader, the dataset shard's type, and
the first loss of GPT-2 tiny over ``iter_torch_batches(device="cpu")``,
held to JAX's ``gpt2.loss_fn`` on the same parameters and rows.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ray_tpu_torch import data, train
from ray_tpu_torch.train.config import RunConfig, ScalingConfig

WORKERS = 2
BATCH, SEQ = 2, 16
DDP_TOL = 1e-6  # f32 gradients of a 4x3 linear layer, two halves averaged
LOSS_TOL = 1e-5  # tests/test_torch_gpt2.py's f32 loss bound


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the spawned workers
        yield
    torch.set_num_threads(n)


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
    ports = {rec["MASTER_PORT"] for rec in recs}
    assert len(ports) == 1 and int(ports.pop()) > 0
    for r, rec in enumerate(recs):
        assert rec["MASTER_ADDR"] == "127.0.0.1"
        assert (rec["RANK"], rec["LOCAL_RANK"], rec["WORLD_SIZE"]) == (
            str(r), str(r), str(WORKERS))
        assert rec["backend"] == "gloo"


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


def test_torch_trainer_on_the_gpu_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.TorchTrainer(_torch_loop, scaling_config=ScalingConfig())


# ---------------------------------------------------------------------------
# the exports

# the JAX package's names the port leaves out, and why
TRAIN_LEFT_OUT = {
    "JaxTrainer": "DataParallelTrainer is its counterpart",
    "XGBoostTrainer": "no device compute; xgboost is in neither image",
    "LightGBMTrainer": "no device compute; lightgbm is in neither image",
}
LLM_LEFT_OUT = {
    "build_openai_app": "needs a serve runtime",
    "build_pd_openai_app": "needs a serve runtime",
}


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
