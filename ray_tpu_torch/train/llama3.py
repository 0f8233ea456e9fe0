"""Llama-3 8B pretraining recipe: the north-star configuration.

Counterpart of ``ray_tpu/train/llama3.py``.  ``train_llama3_8b`` runs
``llama3_train_loop`` through ``DataParallelTrainer``: one worker process
per GPU (the JAX recipe runs one worker per host driving every local
chip), each building an ``fsdp x tp`` mesh over the group, the sharded
state (``create_train_state(..., mesh=...)``), the sharded step, the
goodput tracker, ``torch.distributed.checkpoint`` saves (each rank writes
its shards) and ``train.report``.

On one H100:

    from ray_tpu_torch.train.llama3 import train_llama3_8b
    result = train_llama3_8b(num_workers=1, steps=4, n_layers=4,
                             storage_path="/data/llama3-8b")

runs Llama-3 8B's widths (``LlamaConfig.llama3_8b()``) on the mesh
``{"fsdp": 1, "tp": 1}`` at the recipe's batch 2 x seq 8192.  ``n_layers``
is the port's cut for one card: the f32 weights, gradients and Adam
moments with the update's temporaries cost 28 B a parameter, so 32 layers
(8.0B parameters) need ~225 GB and 4 layers (1.92B) ~54 GB of the card's
80 GB.

Dry run (tests, a laptop): ``train_llama3_8b(dry_run=True,
device="cpu")`` uses the 8B-shaped tiny geometry
(``LlamaConfig.llama3_8b_dry``) over however many workers run, tp 2 where
their number is even, as the JAX recipe fits its devices.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

from ray_tpu_torch.train.trainer import DataParallelTrainer

# fsdp over every worker, no tensor parallelism: on one card {"fsdp": 1,
# "tp": 1}
DEFAULT_MESH = {"fsdp": -1, "tp": 1}


def llama3_train_loop(config: dict):
    """Per-worker loop: mesh -> sharded state -> step -> checkpoint.

    Instrumented with the goodput tracker (``util/goodput.py``): the
    kernel build runs under the compile bracket, each step is split into
    data / h2d / compute / checkpoint phases, and the reported
    ``tokens_per_sec`` is steady-state, past the first step (which warms
    the allocator and the GEMM heuristics).  Every rank draws the same
    global batch from the seed; the step takes the rank's block."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import mesh as mesh_mod
    from ray_tpu_torch.train import context as train_context
    from ray_tpu_torch.train.checkpoint import Checkpoint, save_pytree
    from ray_tpu_torch.train.step import (
        create_train_state,
        default_optimizer,
        make_train_step,
        tree_leaves,
    )
    from ray_tpu_torch.util import goodput as goodput_mod

    ctx = train_context.get_context()
    device = torch.device(ctx.get_device())
    dry = config.get("dry_run", False)
    cfg = (llama.LlamaConfig.llama3_8b_dry() if dry
           else llama.LlamaConfig.llama3_8b())
    if config.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=int(config["n_layers"]))
    world = ctx.get_world_size()
    if dry:
        # fit whatever workers exist, keeping the fsdp x tp structure
        tp = 2 if world % 2 == 0 else 1
        axes = {"fsdp": world // tp, "tp": tp}
    else:
        axes = dict(config.get("mesh", DEFAULT_MESH))
    mesh_cfg = mesh_mod.MeshConfig(**axes)
    mesh = mesh_mod.create_mesh(mesh_cfg, device_type=device.type)
    mesh_mod.set_active_mesh_context(mesh_mod.MeshContext(mesh=mesh))

    steps = int(config.get("steps", 10))
    seq_len = int(config.get("seq_len", 128 if dry else 8192))
    fsdp = mesh_cfg.resolved(world)["fsdp"]
    batch = int(config.get("batch", fsdp * (1 if dry else 2)))
    ckpt_every = int(config.get("ckpt_every", max(1, steps)))
    seed = config.get("seed", 0)

    opt = default_optimizer(learning_rate=config.get("lr", 3e-4))
    state = create_train_state(
        llama, cfg, opt, torch.Generator(device=device).manual_seed(seed),
        device, mesh=mesh)
    step = make_train_step(llama, cfg, opt,
                           attn_impl=config.get("attn_impl", "flash"),
                           mesh=mesh)
    tok_per_step = batch * seq_len
    run_name = config.get("run_name") or (
        "llama3-8b-dry" if dry else "llama3-8b")
    gp = goodput_mod.GoodputTracker(run=run_name,
                                    tokens_per_step=tok_per_step)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    gp.set_flops_per_step(
        goodput_mod.analytic_step_flops(n_params, tok_per_step), "analytic")
    np_rng = np.random.default_rng(seed + 1234)

    def host_batch():
        return np_rng.integers(0, cfg.vocab_size, size=(batch, seq_len + 1),
                               dtype=np.int32)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with gp.compile_bracket():
        if device.type == "cuda":  # the kernels build at first use
            from ray_tpu_torch.ops import _build

            _build.build(["flash_fwd", "flash_bwd"])
    batch_np = host_batch()
    for i in range(steps):
        with gp.step() as st:
            if i > 0:
                with st.phase("data"):
                    batch_np = host_batch()
            with st.phase("h2d"):
                tokens = torch.from_numpy(batch_np).to(device).long()
            with st.phase("compute"):
                state, metrics = step(state, tokens)
                loss = float(metrics["loss"])  # waits for the step
            if (i + 1) % ckpt_every == 0 or i + 1 == steps:
                ckpt_dir = os.path.join(ctx.experiment_dir,
                                        f"ckpt-{i + 1:06d}")
                with st.phase("checkpoint"):
                    t0 = time.perf_counter()
                    # each rank writes its shards; a restore reshards
                    nbytes = save_pytree(ckpt_dir, state)
                    sync()
                    save_s = time.perf_counter() - t0
                rep = gp.report()
                train_context.report(
                    {"loss": loss, "step": i + 1,
                     "grad_norm": float(metrics["grad_norm"]),
                     "tokens_per_sec": rep["tokens_per_sec_steady"] or 0.0,
                     "compile_s": rep["compile_s"],
                     "mfu": rep["mfu"],
                     "model_tflops_per_s": rep["model_tflops_per_s"],
                     "flops_source": rep["flops_source"],
                     "goodput_fraction": rep["fractions"]["goodput"],
                     "n_params": n_params,
                     "checkpoint_s": save_s,
                     "checkpoint_bytes": nbytes},
                    checkpoint=Checkpoint.from_directory(ckpt_dir))
    gp.close()


def train_llama3_8b(num_workers: int = 1, dry_run: bool = False,
                    storage_path: Optional[str] = None, **config):
    """The north-star entry point: ``DataParallelTrainer`` over the 8B
    recipe, one worker per GPU (on the CPU with ``device="cpu"``)."""
    from ray_tpu_torch.train.config import RunConfig, ScalingConfig

    config = dict(config, dry_run=dry_run)
    trainer = DataParallelTrainer(
        llama3_train_loop,
        train_loop_config=config,
        scaling_config=ScalingConfig(
            num_workers=num_workers, use_gpu=config.get("device") != "cpu"),
        run_config=(RunConfig(storage_path=storage_path)
                    if storage_path else None),
    )
    return trainer.fit()
