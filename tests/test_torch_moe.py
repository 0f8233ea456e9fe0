"""The port's MoE model against the JAX package's, on the same weights.

JAX parameters go through ``convert.moe_params_from_jax`` unchanged; the
JAX forward runs its attention through XLA (``attn_impl="xla"``), the
port's through ``flash_attention`` (its plain version on CPU tensors).
Routing is held equal before any value: ``jax.lax.top_k`` breaks a tie
toward the lower index and ``torch.topk`` promises nothing, so the inputs
come from seeds whose smallest top-k margin is far above f32 rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import moe as jmoe
from ray_tpu.parallel.mesh import single_device_mesh
from ray_tpu.train import step as jstep
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.train import step as tstep

# moe_mlp in f32: the same products summed in other orders
OUT_TOL, AUX_TOL = 1e-5, 1e-6
# two f32 layers, then the f32 head over d 128
LOGIT_TOL = 1e-4
# the mean next-token CE plus 0.01 * aux, f32
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# one train step, as tests/test_torch_train_step.py holds GPT-2's
STEP_LOSS_TOL, NORM_RTOL, PARAM_TOL = 1e-5, 1e-5, 1e-5
# bf16 forwards round every activation independently; chip_smoke.py's
# APPLY_TOL, 5% of the largest logit
BF16_APPLY_TOL = 0.05
# the smallest gap between neighbouring sorted router probabilities that
# the seeds give: far above the f32 differences of the two forwards
# (~1e-6), so both pick the same experts in the same order
MIN_MARGIN = 1e-4


def _configs(**kw):
    jcfg = dataclasses.replace(jmoe.MoEConfig.tiny(), dtype="float32", **kw)
    return jcfg, tmoe.MoEConfig(**dataclasses.asdict(jcfg))


def _jax_routing(cfg, xf, router_w):
    """``top_idx``, ``keep`` and the probabilities, by the lines of
    ``ray_tpu/models/moe.py``'s ``moe_mlp`` that route."""
    n = xf.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = jmoe.expert_capacity(cfg, n)
    logits = xf.astype(jnp.float32) @ router_w.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(top_idx, e, dtype=jnp.float32)
    flat = onehot.transpose(1, 0, 2).reshape(k * n, e)
    pos = (jnp.cumsum(flat, axis=0) - flat).reshape(k, n, e).transpose(
        1, 0, 2)
    keep = jnp.sum(pos * onehot, axis=-1) < cap
    return np.asarray(top_idx), np.asarray(keep), np.asarray(probs)


def _margin(probs):
    """Smallest gap between neighbouring sorted probabilities of a token,
    over the top k + 1 (the order and the cut both decide routing)."""
    top = -np.sort(-probs, axis=-1)[:, :3]
    return float(np.diff(-top, axis=-1).min())


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _configs()
    params = jmoe.init(jcfg, jax.random.PRNGKey(0))
    state = convert.moe_params_from_jax(jax.tree.map(np.asarray, params),
                                        device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 33))
    return jcfg, tcfg, params, state, tokens


@pytest.fixture(scope="module")
def jax_loss_and_grads(tiny):
    jcfg, _, params, _, tokens = tiny
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jmoe.loss_fn(p, t, jcfg, attn_impl="xla")))(
            params, jnp.asarray(tokens, jnp.int32))
    return float(loss), jax.tree.map(np.asarray, grads)


def _node(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_config_copy_matches():
    for name in ("tiny", "mixtral_8x7b"):
        want = dataclasses.asdict(getattr(jmoe.MoEConfig, name)())
        assert dataclasses.asdict(getattr(tmoe.MoEConfig, name)()) == want
    assert tmoe.MoEConfig.mixtral_8x7b().head_dim == 128


@pytest.mark.parametrize("factor", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("n_tokens", [1, 7, 32, 64, 100, 4096])
def test_expert_capacity_matches_jax(n_tokens, factor):
    jcfg, tcfg = _configs(capacity_factor=factor)
    got = tmoe.expert_capacity(tcfg, n_tokens)
    assert got == jmoe.expert_capacity(jcfg, n_tokens)
    assert got % 8 == 0 and got >= 8
    assert tmoe.expert_capacity(tmoe.MoEConfig.mixtral_8x7b(), 4096) == 1280


def test_param_logical_specs_mirror_init(tiny):
    _, tcfg, params, _, _ = tiny
    specs = tmoe.param_logical_specs(tcfg)
    state = tmoe.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        spec = _node(specs, path)
        assert isinstance(spec, tuple) and len(spec) == leaf.ndim, path
        assert tuple(_node(state, path).shape) == leaf.shape, path
        assert _node(state, path).dtype == torch.float32
    n_specs = len(jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, tuple)))
    assert n_specs == len(jax.tree_util.tree_leaves(params))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmoe.init(tcfg)


def test_convert_keeps_tree_and_values(tiny):
    _, _, params, state, _ = tiny
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(_node(state, path).numpy(),
                                      np.asarray(leaf))


def _mlp_inputs(cfg, params, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(
        (2, 16, cfg.d_model), dtype=np.float32)
    router = params["layers"]["router"][0]
    experts = jax.tree.map(lambda w: w[0], params["layers"]["experts"])
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    texperts = {k: torch.from_numpy(np.array(v)) for k, v in experts.items()}
    return (jx, router, experts), (tx, torch.from_numpy(np.array(router)),
                                   texperts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [0.5, 1.25, 8.0])
def test_routing_matches_jax(tiny, factor, dtype):
    jcfg, tcfg = _configs(capacity_factor=factor)
    _, _, params, _, _ = tiny
    (jx, jrouter, _), (tx, trouter, _) = _mlp_inputs(jcfg, params, 2, dtype)
    want_idx, want_keep, probs = _jax_routing(
        jcfg, jx.reshape(-1, jcfg.d_model), jrouter)
    assert _margin(probs) > MIN_MARGIN
    r = tmoe.route(tcfg, tx.reshape(-1, tcfg.d_model), trouter)
    np.testing.assert_array_equal(r["top_idx"].numpy(), want_idx)
    np.testing.assert_array_equal(r["keep"].numpy(), want_keep)
    # each kept choice takes one slot of its expert; a dropped one none
    disp = r["dispatch"].numpy()
    assert disp.sum() == want_keep.sum()
    assert disp.sum(axis=0).max() <= 1
    if factor == 0.5:
        assert not want_keep.all()  # tokens are dropped
    if factor == 8.0:
        assert want_keep.all()


@pytest.mark.parametrize("factor", [0.5, 1.25, 8.0])
def test_moe_mlp_matches_jax(tiny, factor):
    jcfg, tcfg = _configs(capacity_factor=factor)
    _, _, params, _, _ = tiny
    jargs, targs = _mlp_inputs(jcfg, params, 2, "float32")
    want_out, want_aux = jmoe.moe_mlp(jcfg, *jargs)
    got_out, got_aux = tmoe.moe_mlp(tcfg, *targs)
    assert got_out.shape == want_out.shape
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=0, atol=OUT_TOL)
    assert abs(got_aux.item() - float(want_aux)) < AUX_TOL


def test_no_drops_at_high_capacity():
    """With capacity_factor >> 1 every token is routed: the output is
    non-zero wherever the input is (``tests/test_moe_pipeline.py``)."""
    cfg = dataclasses.replace(tmoe.MoEConfig.tiny(), capacity_factor=8.0,
                              n_layers=1)
    state = tmoe.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    out, aux = tmoe.moe_mlp(cfg, x, state["layers"]["router"][0],
                            tllama.layer_params(
                                state["layers"]["experts"], 0))
    r = tmoe.route(cfg, x.reshape(-1, cfg.d_model),
                   state["layers"]["router"][0])
    assert out.shape == x.shape and bool(r["keep"].all())
    assert bool((out.abs().amax(dim=-1) > 0).all())
    assert np.isfinite(aux.item())


def test_layer_routing_margins(tiny):
    """The apply-level tests below rely on both forwards routing alike in
    every layer: the port's per-layer routing has a margin far above the
    two forwards' f32 differences."""
    _, tcfg, _, state, tokens = tiny
    x = state["embed"][torch.from_numpy(tokens[:, :-1])]
    positions = torch.arange(x.shape[1])[None, :]
    attn = tllama._attention("flash")
    for i in range(tcfg.n_layers):
        p = tllama.layer_params(state["layers"], i)
        h = tllama.rms_norm(tllama._attention_block(tcfg, x, p, positions,
                                                    attn),
                            p["mlp_norm"], tcfg.norm_eps)
        r = tmoe.route(tcfg, h.reshape(-1, tcfg.d_model), p["router"])
        assert _margin(r["probs"].numpy()) > MIN_MARGIN, i
        x, _ = tmoe._layer(tcfg, x, p, positions, attn, None, None)


def test_apply_logits_and_aux_match_jax(tiny):
    jcfg, tcfg, params, state, tokens = tiny
    inp = tokens[:, :-1]
    want, want_aux = jmoe.apply(params, jnp.asarray(inp, jnp.int32), jcfg,
                                attn_impl="xla", return_aux=True)
    for impl in ("flash", "plain"):
        got, aux = tmoe.apply(state, torch.from_numpy(inp), tcfg,
                              attn_impl=impl, return_aux=True)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_TOL)
        assert abs(aux.item() - float(want_aux)) < AUX_TOL
    assert torch.equal(tmoe.apply(state, torch.from_numpy(inp), tcfg), got)


def test_loss_matches_jax(tiny, jax_loss_and_grads):
    _, tcfg, _, state, tokens = tiny
    loss = tmoe.loss_fn(state, torch.from_numpy(tokens), tcfg)
    assert abs(loss.item() - jax_loss_and_grads[0]) < LOSS_TOL


def _torch_grads(state, tokens, cfg):
    params = tstep.tree_map(lambda t: t.detach().requires_grad_(), state)
    loss = tmoe.loss_fn(params, torch.from_numpy(tokens), cfg)
    grads = torch.autograd.grad(loss, tstep.tree_leaves(params))
    it = iter(grads)
    return loss, tstep.tree_map(lambda _: next(it), state)


def test_gradients_match_jax(tiny, jax_loss_and_grads):
    _, tcfg, _, state, tokens = tiny
    _, grads = _torch_grads(state, tokens, tcfg)
    want = jax_loss_and_grads[1]
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(_node(grads, path).numpy(), leaf,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=str(path))
    # the experts of both layers and the router all learn
    assert all(float(np.abs(_node(want, p)).max()) > 0
               for p, _ in jax.tree_util.tree_leaves_with_path(want))


def test_remat_gives_the_same_gradients(tiny):
    _, tcfg, _, state, tokens = tiny
    loss0, g0 = _torch_grads(state, tokens, tcfg)
    loss1, g1 = _torch_grads(state, tokens,
                             dataclasses.replace(tcfg, remat=True))
    assert loss0.item() == loss1.item()
    for a, b in zip(tstep.tree_leaves(g0), tstep.tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_matches_jax(tiny):
    """``make_train_step`` on the tiny MoE against JAX's on a one-device
    mesh, from the same parameters and batch.  The first update has
    learning rate 0 (the schedule is read before the count moves), so two
    steps: the second moves the parameters."""
    jcfg, tcfg, params, _, tokens = tiny
    opt_j = jstep.default_optimizer(warmup_steps=1)
    opt_t = tstep.default_optimizer(warmup_steps=1)
    mesh = single_device_mesh()
    tparams = convert.moe_params_from_jax(jax.tree.map(np.asarray, params),
                                          device="cpu")
    tstate = {"params": tparams, "opt_state": opt_t.init(tparams), "step": 0}
    trun = tstep.make_train_step(tmoe, tcfg, opt_t)
    with mesh:
        jstate = {"params": params, "opt_state": opt_j.init(params),
                  "step": jnp.zeros((), jnp.int32)}
        jrun = jstep.make_train_step(jmoe, jcfg, mesh, opt_j, donate=False)
        for i in range(2):
            jstate, jm = jrun(jstate, jnp.asarray(tokens, jnp.int32))
            tstate, tm = trun(tstate, torch.from_numpy(tokens))
            assert abs(tm["loss"].item() - float(jm["loss"])) \
                < STEP_LOSS_TOL, i
            assert tm["grad_norm"].item() == pytest.approx(
                float(jm["grad_norm"]), rel=NORM_RTOL), i
        jparams = jax.tree.map(np.asarray, jstate["params"])
    moved = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        got = _node(tstate["params"], path).detach().numpy()
        assert np.abs(got - leaf).max() < PARAM_TOL, path
        moved = max(moved, float(np.abs(leaf - np.asarray(
            _node(params, path))).max()))
    assert moved > 10 * PARAM_TOL


def test_bf16_routing_and_logits_match_jax(tiny):
    jcfg, tcfg, params, state, tokens = tiny
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    inp = tokens[:, :-1]
    want = np.asarray(jmoe.apply(params, jnp.asarray(inp, jnp.int32), jcfg,
                                 attn_impl="xla"))
    got = tmoe.apply(state, torch.from_numpy(inp), tcfg)
    scale = float(np.abs(want).max())
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= \
        BF16_APPLY_TOL * max(1.0, scale)
