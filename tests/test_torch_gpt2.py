"""The port's GPT-2 against the JAX package's, on the same weights.

JAX parameters go through ``convert.gpt2_params_from_jax`` unchanged.  The
JAX side runs its attention through the Pallas kernels in interpret mode;
the port's "flash" path takes the kernels' plain versions on CPU tensors.
Everything is f32 at the tiny config, so the two differ only by the order
of f32 sums.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch import convert
from ray_tpu_torch.models import gpt2 as tgpt2

# f32 logits ~N(0, 0.1) through two layers summed in other orders
LOGIT_TOL = 1e-5
# the mean NLL (~ln 512 = 6.24) and its gradients: f32 summation order
LOSS_TOL = 1e-5
# each gradient leaf: f32 summation order, relative to its largest entry
GRAD_RTOL = 1e-5


def _configs(**kw):
    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype="float32", **kw)
    return jcfg, tgpt2.GPT2Config(**dataclasses.asdict(jcfg))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _node(state, path):
    for key in path:
        state = state[key.key]
    return state


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _configs()
    params = jgpt2.init(jcfg, jax.random.PRNGKey(0))
    state = convert.gpt2_params_from_jax(jax.tree.map(np.asarray, params),
                                         device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 65))
    return jcfg, tcfg, params, state, tokens


def test_config_copy_matches():
    for name in ("tiny", "gpt2_124m"):
        want = dataclasses.asdict(getattr(jgpt2.GPT2Config, name)())
        got = dataclasses.asdict(getattr(tgpt2.GPT2Config, name)())
        assert got == want, name
    cfg = tgpt2.GPT2Config.gpt2_124m()
    assert (cfg.head_dim, cfg.d_ff) == (64, 3072)


def test_init_layout_scales_and_device_rule():
    _, tcfg = _configs()
    state = tgpt2.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    params = jgpt2.init(jgpt2.GPT2Config(**dataclasses.asdict(tcfg)),
                        jax.random.PRNGKey(0))
    for path, leaf in _leaves(params):
        node = _node(state, path)
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        # the same init distribution: zeros, ones, or normal(std)
        want_std, got_std = float(np.std(np.asarray(leaf))), float(node.std())
        assert abs(got_std - want_std) <= 0.2 * want_std + 1e-7, path
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tgpt2.init(tcfg)


def test_convert_keeps_tree_and_values(tiny):
    _, _, params, state, _ = tiny
    for path, leaf in _leaves(params):
        np.testing.assert_array_equal(_node(state, path).numpy(),
                                      np.asarray(leaf))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2.0 ** -7)])
def test_layer_norm_matches_jax(dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64), dtype=np.float32) * 3 + 1
    g, b = (rng.standard_normal((64,), dtype=np.float32) for _ in range(2))
    want = jgpt2.layer_norm(jnp.asarray(x, dtype), jnp.asarray(g),
                            jnp.asarray(b), 1e-5)
    got = tgpt2.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    # bf16: one bf16 ulp of the largest |value|; f32: summation order
    bound = tol * (np.abs(want).max() if dtype == "bfloat16" else 1.0)
    assert np.abs(got.float().numpy() - want).max() <= bound


def test_apply_logits_match_pallas_forward(tiny):
    jcfg, tcfg, params, state, tokens = tiny
    want = np.asarray(jgpt2.apply(params, jnp.asarray(tokens, jnp.int32),
                                  jcfg, attn_impl="pallas"))
    for impl in ("flash", "plain"):
        got = tgpt2.apply(state, torch.from_numpy(tokens), tcfg,
                          attn_impl=impl)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() < LOGIT_TOL, impl


@pytest.mark.parametrize("remat,jax_attn", [(False, "pallas"),
                                             (True, "xla")])
def test_loss_and_grads_match_jax(tiny, remat, jax_attn):
    """``loss_fn`` and its gradients (through the FlashAttention Function
    and, with remat, per-layer checkpoints) against
    ``jax.value_and_grad(gpt2.loss_fn)``, through the Pallas backward
    kernels or, with remat, JAX's plain attention (a cheaper compile)."""
    jcfg, tcfg, params, _, tokens = tiny
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    want_loss, want_grads = jax.value_and_grad(jgpt2.loss_fn)(
        params, jnp.asarray(tokens, jnp.int32), jcfg, attn_impl=jax_attn)
    state = convert.gpt2_params_from_jax(jax.tree.map(np.asarray, params),
                                         device="cpu")
    leaves = [(path, _node(state, path).requires_grad_())
              for path, _ in _leaves(params)]
    loss = tgpt2.loss_fn(state, torch.from_numpy(tokens), tcfg)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    assert abs(loss.item() - float(want_loss)) < LOSS_TOL
    for (path, _), g in zip(leaves, grads):
        want = np.asarray(_node(want_grads, path))
        bound = GRAD_RTOL * np.abs(want).max()
        assert np.abs(g.numpy() - want).max() <= bound, path
