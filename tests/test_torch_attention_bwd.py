"""The port's flash-attention backward against the JAX package's Pallas
backward kernels and float64 truth.

The same numpy inputs go through ``ray_tpu.ops.attention._flash_backward``
(the dK/dV and dQ Pallas kernels in interpret mode, on K/V heads repeated
as JAX's public API repeats them) and through the port: its plain backward,
``flash_backward`` on CPU tensors (which takes the plain version) and
gradients of ``flash_attention`` through the ``FlashAttention`` autograd
Function.  The bound is the JAX package's own (tests/test_attention.py):
an f32 backward must be within 2x the dense f32 backward's distance from
float64 truth, plus 1e-4.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

# (batch, heads, kv_heads, seq_q, seq_k, head_dim, causal, jax_block)
CASES = {
    "causal": (2, 2, 2, 128, 128, 32, True, 64),
    "full": (2, 2, 2, 128, 128, 32, False, 64),
    "gqa_4_2": (1, 4, 2, 128, 128, 64, True, 64),
    # the Pallas kernels slice their full-sequence refs with pl.ds, which
    # clamps the last block of a ragged sequence onto earlier rows; one
    # block covering the whole sequence is what they compute right
    "ragged": (1, 4, 2, 100, 100, 32, True, 256),
    "ragged_full": (1, 2, 1, 77, 130, 32, False, 256),
}
# port and Pallas backwards against float64 truth: 2x the dense f32
# backward's error, plus 1e-4 (tests/test_attention.py:72-92)
DENSE_FACTOR, DENSE_SLACK = 2.0, 1e-4


def _inputs(b, h, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b * h, sq, d), dtype=np.float32)
    k = rng.standard_normal((b * hkv, sk, d), dtype=np.float32)
    v = rng.standard_normal((b * hkv, sk, d), dtype=np.float32)
    do = rng.standard_normal((b * h, sq, d), dtype=np.float32)
    return q, k, v, do


def _dense_grads(q, k, v, do, causal, scale, dtype):
    """Autograd of plain softmax attention in ``dtype``: the dense f32
    backward and, in float64, the truth."""
    group = q.shape[0] // k.shape[0]
    q, k, v = (torch.tensor(x, dtype=dtype, requires_grad=True)
               for x in (q, k, v))
    kr, vr = (x.repeat_interleave(group, dim=0) for x in (k, v))
    s = q @ kr.transpose(1, 2) * scale
    if causal:
        sq, sk = s.shape[1:]
        s = s.masked_fill(torch.arange(sq)[:, None] < torch.arange(sk),
                          float("-inf"))
    out = torch.softmax(s, dim=-1) @ vr
    grads = torch.autograd.grad(out, (q, k, v), torch.tensor(do, dtype=dtype))
    return [g.double().numpy() for g in grads]


def _pallas_grads(q, k, v, do, causal, scale, block):
    group = q.shape[0] // k.shape[0]
    jq, jdo = jnp.asarray(q), jnp.asarray(do)
    jk, jv = (jnp.asarray(np.repeat(x, group, axis=0)) for x in (k, v))
    out, lse = jattn._flash_forward(jq, jk, jv, causal=causal, sm_scale=scale,
                                    block_q=block, block_k=block,
                                    interpret=True)
    dq, dk, dv = jattn._flash_backward(
        jq, jk, jv, out, lse, jdo, causal=causal, sm_scale=scale,
        block_q=block, block_k=block, interpret=True)

    def fold(x):  # repeated heads -> KV heads: the VJP of the repeat
        x = np.asarray(x, np.float64)
        return x.reshape(k.shape[0], group, *x.shape[1:]).sum(axis=1)

    return [np.asarray(dq, np.float64), fold(dk), fold(dv)]


def _port_grads(q, k, v, do, causal, scale):
    """{name: [dq, dk, dv]} for the port's three ways to the gradient."""
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = tattn.flash_forward(tq, tk, tv, causal, scale)
    got = {
        "plain": tattn.reference_attention_backward(tq, tk, tv, out, lse, tdo,
                                                    causal, scale),
        "flash_backward": tattn.flash_backward(tq, tk, tv, out, lse, tdo,
                                               causal, scale),
    }
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    got["autograd"] = torch.autograd.grad(
        tattn.FlashAttention.apply(*leaves, causal, scale), leaves, tdo)
    return {n: [g.double().numpy() for g in gs] for n, gs in got.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_pallas_and_truth(case):
    b, h, hkv, sq, sk, d, causal, block = CASES[case]
    q, k, v, do = _inputs(b, h, hkv, sq, sk, d, seed=len(case))
    scale = 1.0 / math.sqrt(d)
    truth = _dense_grads(q, k, v, do, causal, scale, torch.float64)
    dense = _dense_grads(q, k, v, do, causal, scale, torch.float32)
    candidates = _port_grads(q, k, v, do, causal, scale)
    candidates["pallas"] = _pallas_grads(q, k, v, do, causal, scale, block)
    for i, name in enumerate(("dq", "dk", "dv")):
        err_dense = np.abs(dense[i] - truth[i]).max()
        bound = DENSE_FACTOR * err_dense + DENSE_SLACK
        for who, grads in candidates.items():
            assert grads[i].shape == truth[i].shape, (who, name)
            err = np.abs(grads[i] - truth[i]).max()
            assert err < bound, f"{who} {name}: {err} vs dense {err_dense}"


def test_flash_attention_gradients_in_bshd_layout():
    """Gradients through the public (b, s, h, d) API come back in that
    layout and equal those of the plain attention under autograd."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 64, 4, 32), dtype=np.float32)
    k = rng.standard_normal((2, 64, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, 64, 2, 32), dtype=np.float32)
    grads = {}
    for name, fn in tattn.ATTENTION.items():
        leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        loss = (fn(*leaves, causal=True) ** 2).sum()
        grads[name] = torch.autograd.grad(loss, leaves)
    for a, b, x in zip(grads["flash"], grads["plain"], (q, k, v)):
        assert a.shape == x.shape
        # the same f32 math, the backward kernels' plain version against
        # autograd's own order of operations
        assert (a - b).abs().max() < 1e-4


def test_row_with_no_column_gets_zero_gradient():
    """A row whose forward saw no column has lse = +1e30: p = 0, so its dQ
    row is 0 and it adds nothing to dK or dV."""
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(1, 2, 2, 16, 16, 32, seed=3))
    scale = 1.0 / math.sqrt(32)
    out, lse = tattn.flash_forward(q, k, v, True, scale)
    lse[:, 5] = 1e30
    out[:, 5] = 0.0
    dq, dk, dv = tattn.flash_backward(q, k, v, out, lse, do, True, scale)
    assert torch.equal(dq[:, 5], torch.zeros_like(dq[:, 5]))
    do_cut = do.clone()
    do_cut[:, 5] = 0.0
    _, dk_cut, dv_cut = tattn.flash_backward(q, k, v, out, lse, do_cut, True,
                                             scale)
    torch.testing.assert_close(dk, dk_cut, rtol=0, atol=1e-6)
    torch.testing.assert_close(dv, dv_cut, rtol=0, atol=1e-6)
    # no key at all: every row has lse = +1e30
    empty = torch.zeros(2, 0, 32)
    out, lse = tattn.flash_forward(q, empty, empty, False, scale)
    dq, dk, dv = tattn.flash_backward(q, empty, empty, out, lse, do, False,
                                      scale)
    assert torch.equal(dq, torch.zeros_like(q)) and dk.shape == (2, 0, 32)


def test_inference_mode_counts_forward_only():
    """The engine's calls under ``torch.inference_mode`` go through the
    autograd Function and record no graph; CPU tensors launch nothing."""
    x = torch.randn(1, 8, 2, 32)
    launches = tattn.flash_forward.launches
    bwd = dict(tattn.flash_backward.launches)
    with torch.inference_mode():
        out = tattn.flash_attention(x, x, x)
    assert out.shape == x.shape and not out.requires_grad
    assert tattn.flash_forward.launches == launches
    assert tattn.flash_backward.launches == bwd


def test_backward_rejects_bad_shapes_and_devices():
    q = torch.randn(4, 8, 32)
    lse = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        tattn.flash_backward(q, q, q, q, torch.zeros(4, 7), q, True, 0.1)
    meta = torch.empty(4, 8, 32, device="meta")
    with pytest.raises(ValueError):
        tattn.flash_backward(meta, meta, meta, meta, lse.to("meta"), meta,
                             True, 0.1)
