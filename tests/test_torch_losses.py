"""The port's loss heads against the JAX package's, with gradients.

``chunked_softmax_xent`` chunked (with a padded tail) and in one pass, and
``llama.loss_fn`` (chunked, with per-layer checkpoints), on the same numpy
inputs as ``ray_tpu/models/losses.py`` and ``ray_tpu/models/llama.py``.
Everything is f32, so the two differ only by the order of f32 sums.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu.models import losses as jlosses
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import losses as tlosses

B, S, D, V = 2, 50, 32, 97
# a mean NLL near ln 97 = 4.6 summed in another order
LOSS_TOL = 1e-5
# gradients, relative to each one's largest entry: f32 summation order
GRAD_RTOL = 1e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    head = rng.standard_normal((D, V), dtype=np.float32) * 0.2
    targets = rng.integers(0, V, (B, S))
    return x, head, targets


def _close(got, want):
    want = np.asarray(want)
    bound = GRAD_RTOL * np.abs(want).max()
    return np.abs(got.detach().numpy() - want).max() <= bound


@pytest.mark.parametrize("chunk", [0, 16, 50, 64])
def test_xent_and_grads_match_jax(chunk):
    """chunk 16 pads 50 to 64 and masks the tail; 0, 50 and 64 are one
    pass."""
    x, head, targets = _inputs()
    want, (wx, wh) = jax.value_and_grad(
        jlosses.chunked_softmax_xent, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head), jnp.asarray(targets, jnp.int32),
        chunk=chunk)
    tx, th = (torch.tensor(a, requires_grad=True) for a in (x, head))
    got = tlosses.chunked_softmax_xent(tx, th, torch.from_numpy(targets),
                                       chunk=chunk)
    gx, gh = torch.autograd.grad(got, (tx, th))
    assert abs(got.item() - float(want)) < LOSS_TOL
    assert _close(gx, wx) and _close(gh, wh)


def test_chunked_equals_single_pass():
    """The padded, checkpointed chunks sum to the single pass: the mean is
    over batch * seq, not over the padded length."""
    x, head, targets = _inputs(seed=1)
    results = []
    for chunk in (0, 7, 16):
        tx, th = (torch.tensor(a, requires_grad=True) for a in (x, head))
        loss = tlosses.chunked_softmax_xent(tx, th, torch.from_numpy(targets),
                                            chunk=chunk)
        results.append((loss.detach(), *torch.autograd.grad(loss, (tx, th))))
    for other in results[1:]:
        for a, b in zip(results[0], other):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_bf16_head_gives_f32_logits_of_rounded_operands():
    """bf16 operands, f32 logits: on the CPU the exact products of the
    rounded operands, summed in f32."""
    x, head, _ = _inputs(seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    logits = tlosses.head_logits(xb, torch.from_numpy(head))
    want = xb.float() @ torch.from_numpy(head).to(torch.bfloat16).float()
    assert logits.dtype == torch.float32
    torch.testing.assert_close(logits, want, rtol=0, atol=0)


def test_llama_loss_fn_matches_jax():
    """``llama.loss_fn`` with chunked loss (seq 64 in chunks of 24, padded)
    and per-layer checkpoints against ``jax.value_and_grad`` through JAX's
    plain attention (the Pallas kernels are held to the port in
    tests/test_torch_attention_bwd.py)."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32",
                               remat=True, loss_chunk=24)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    params = jllama.init(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 65))
    want, wgrads = jax.value_and_grad(jllama.loss_fn)(
        params, jnp.asarray(tokens, jnp.int32), jcfg, attn_impl="xla")
    state = convert.llama_params_from_jax(jax.tree.map(np.asarray, params),
                                          device="cpu")
    paths = [p for p, _ in jax.tree_util.tree_leaves_with_path(params)]

    def node(tree, path):
        for key in path:
            tree = tree[key.key]
        return tree

    leaves = [node(state, p).requires_grad_() for p in paths]
    loss = tllama.loss_fn(state, torch.from_numpy(tokens), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(want)) < LOSS_TOL
    for path, g in zip(paths, grads):
        assert _close(g, node(wgrads, path)), path
