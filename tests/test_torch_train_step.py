"""The port's train step and optimizer against the JAX package's.

``default_optimizer`` is held to optax's ``chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule))`` on the same numpy parameters and
gradients, and three steps of ``make_train_step`` on the tiny GPT-2 are
held to JAX's ``make_train_step`` on a one-device mesh.  Everything is
f32.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel.mesh import MeshConfig, create_mesh
from ray_tpu.train import step as jstep
from ray_tpu_torch import convert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.train import step as tstep

# the schedule in f64 on the host against optax's, which rounds each of
# its few f32 operations: a few f32 ulps
SCHEDULE_RTOL = 1e-5
# one optimizer update from the same gradients: f32 rounding of the same
# elementwise formulas, in a slightly different order
UPDATE_TOL = 1e-6
# a train step's loss and pre-clip grad norm: f32 summation order
LOSS_TOL, NORM_RTOL = 1e-5, 1e-5
# parameters after three steps of lr ~3e-4 from the same start: Adam
# divides by sqrt(nu) + 1e-8, so a gradient entry near 1e-8 carries its f32
# summation-order difference into its update at full relative size; 1e-5
# is 3% of one step's learning rate
PARAM_TOL = 1e-5


def _node(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (1, 10_000),
                                          (5, 3), (10, 40)])
def test_schedule_matches_optax(warmup, total):
    opt = tstep.default_optimizer(warmup_steps=warmup, total_steps=total)
    want = optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, warmup, max(total, warmup + 1))
    counts = sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                     total - 1, total, total + 7, 20_000})
    for count in (c for c in counts if c >= 0):
        # abs: at the end of the cosine, 1 + cos(pi * n / N) cancels in f32
        assert opt.schedule(count) == pytest.approx(
            float(want(count)), rel=SCHEDULE_RTOL, abs=1e-9), count
    assert opt.schedule(0) == 0.0


@pytest.mark.parametrize("grad_scale", [10.0, 1e-3],
                         ids=["clipped", "unclipped"])
def test_update_matches_optax(grad_scale):
    """Three updates with gradients whose global norm is above (clipped)
    or below ``max_norm``: parameters, moments and the pre-clip norm."""
    rng = np.random.default_rng(0)
    # keys in sorted order, which is the order jax.tree.map returns
    params = {"sub": {"b": rng.standard_normal((7,), dtype=np.float32)},
              "w": rng.standard_normal((5, 7), dtype=np.float32)}
    opt_j = jstep.default_optimizer(learning_rate=1e-2, warmup_steps=1,
                                    total_steps=10)
    opt_t = tstep.default_optimizer(learning_rate=1e-2, warmup_steps=1,
                                    total_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    js = opt_j.init(jp)
    tp = convert.params_from_jax(params, device="cpu")
    ts = opt_t.init(tp)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: grad_scale * rng.standard_normal(a.shape, np.float32),
            params)
        want_norm = float(optax.global_norm(grads))
        updates, js = opt_j.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt_t.update(tp, tstep.tree_leaves(
            convert.params_from_jax(grads, device="cpu")), ts)
        assert float(norm) == pytest.approx(want_norm, rel=1e-6)
        adam = js[1][0]
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            for got, want in ((tp, leaf), (ts["mu"], adam.mu),
                              (ts["nu"], adam.nu)):
                want = np.asarray(want if got is tp else _node(want, path))
                assert np.abs(_node(got, path).numpy() - want).max() \
                    < UPDATE_TOL, path
    assert ts["count"] == 3


def test_three_train_steps_match_jax():
    """``make_train_step`` on the tiny GPT-2 against JAX's on a one-device
    mesh, from the same parameters and batch, with ``warmup_steps=1`` so
    the second and third updates have a non-zero learning rate."""
    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype="float32")
    tcfg = tgpt2.GPT2Config(**dataclasses.asdict(jcfg))
    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:1])
    opt_j = jstep.default_optimizer(warmup_steps=1)
    opt_t = tstep.default_optimizer(warmup_steps=1)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 33))
    with mesh:
        jstate = jstep.create_train_state(jgpt2, jcfg, mesh, opt_j,
                                          jax.random.PRNGKey(0))
        params = convert.gpt2_params_from_jax(
            jax.tree.map(np.asarray, jstate["params"]), device="cpu")
        start = jax.tree.map(np.asarray, jstate["params"])
        tstate = {"params": params, "opt_state": opt_t.init(params),
                  "step": 0}
        jrun = jstep.make_train_step(jgpt2, jcfg, mesh, opt_j)
        trun = tstep.make_train_step(tgpt2, tcfg, opt_t)
        for i in range(3):
            jstate, jm = jrun(jstate, jnp.asarray(tokens, jnp.int32))
            tstate, tm = trun(tstate, torch.from_numpy(tokens))
            assert abs(tm["loss"].item() - float(jm["loss"])) < LOSS_TOL, i
            assert tm["grad_norm"].item() == pytest.approx(
                float(jm["grad_norm"]), rel=NORM_RTOL), i
        jparams = jax.tree.map(np.asarray, jstate["params"])
    assert tstate["step"] == int(jstate["step"]) == 3
    # updated in place: the returned state holds the same tensors
    assert tstate["params"]["wte"] is params["wte"]
    moved = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        got = _node(tstate["params"], path).detach().numpy()
        assert np.abs(got - leaf).max() < PARAM_TOL, path
        moved = max(moved, float(np.abs(leaf - _node(start, path)).max()))
    assert moved > 10 * PARAM_TOL  # the comparison is not of unmoved params


def test_create_train_state_layout_and_device_rule():
    cfg = tgpt2.GPT2Config.tiny()
    opt = tstep.default_optimizer()
    state = tstep.create_train_state(tgpt2, cfg, opt,
                                     torch.Generator().manual_seed(0),
                                     device="cpu")
    assert state["step"] == 0 and state["opt_state"]["count"] == 0
    leaves = tstep.tree_leaves(state["params"])
    for moments in (state["opt_state"]["mu"], state["opt_state"]["nu"]):
        for p, m in zip(leaves, tstep.tree_leaves(moments)):
            assert m.shape == p.shape and not m.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tstep.create_train_state(tgpt2, cfg, opt)
