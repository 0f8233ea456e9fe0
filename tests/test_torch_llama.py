"""The port's Llama forward against the JAX package's, on the same weights.

JAX parameters go through ``convert.llama_params_from_jax`` unchanged; the
JAX forward runs its attention through the Pallas kernel in interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tllama

# f32 logits ~N(0, 1): two layers of f32 matmuls summed in other orders
LOGIT_TOL = 1e-4


def _configs(**kw):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32",
                               **kw)
    return jcfg, tllama.LlamaConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _configs()
    params = jllama.init(jcfg, jax.random.PRNGKey(0))
    state = convert.llama_params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, state


def test_config_copy_matches():
    for name in ("tiny", "llama3_8b", "llama3_70b", "llama3_8b_dry"):
        want = dataclasses.asdict(getattr(jllama.LlamaConfig, name)())
        got = dataclasses.asdict(getattr(tllama.LlamaConfig, name)())
        assert got == want, name
    assert tllama.LlamaConfig.tiny().head_dim == 32


def test_convert_keeps_tree_and_values(tiny):
    _, _, params, state = tiny
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat_j:
        node = state
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2.0 ** -7)])
def test_rms_norm_matches_jax(dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64), dtype=np.float32)
    w = rng.standard_normal((64,), dtype=np.float32)
    want = jllama.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), 1e-5)
    got = tllama.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(w), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    # bf16: one bf16 ulp of the largest |value| (about 8 here)
    bound = tol * (np.abs(want).max() if dtype == "bfloat16" else 1.0)
    assert np.abs(got.float().numpy() - want).max() <= bound


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 32), dtype=np.float32)
    pos = np.arange(9)[None, :] + np.array([[0], [17]])
    want = np.asarray(jllama.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0))
    got = tllama.rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
    assert np.abs(got.numpy() - want).max() < 1e-5


def test_apply_logits_match_pallas_forward(tiny):
    jcfg, tcfg, params, state = tiny
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 64))
    want = np.asarray(jllama.apply(params, jnp.asarray(tokens, jnp.int32),
                                   jcfg, attn_impl="pallas"))
    for impl in ("flash", "plain"):
        got = tllama.apply(state, torch.from_numpy(tokens), tcfg,
                           attn_impl=impl)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() < LOGIT_TOL, impl


def test_cast_weights_keeps_results(tiny):
    _, tcfg, _, state = tiny
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    cast = tllama.cast_weights(state, cfg)
    assert cast["lm_head"].dtype == torch.float32
    assert cast["layers"]["attn"]["wq"].dtype == torch.bfloat16
    tokens = torch.randint(0, cfg.vocab_size, (1, 32),
                           generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(tllama.apply(cast, tokens, cfg),
                               tllama.apply(state, tokens, cfg),
                               rtol=0, atol=0)


def test_init_layout_and_device_rule():
    _, tcfg = _configs()
    state = tllama.init(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    params = jllama.init(jllama.LlamaConfig(**dataclasses.asdict(tcfg)),
                         jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = state
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tllama.init(tcfg)
